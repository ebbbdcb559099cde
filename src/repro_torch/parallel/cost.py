"""A rank's step cost: FLOPs, bytes and collective bytes (twin of
``repro.parallel.hlo``).

The reference walks the HLO text XLA compiled for one device and derives
the three roofline inputs from it. The port has no compiled program: it
runs its step op by op, so :class:`CostMode` (a ``TorchDispatchMode``)
counts the ops one rank issues in one step, on its local shards, by the
reference's rules:

  * ``flops``: 2 * prod(result) * K for every ``mm``, ``bmm``, ``addmm``,
    ``baddbmm`` and ``convolution`` (K the contracted extent); elementwise
    work is ignored, as in ``hlo.py``;
  * ``bytes``: the inputs plus the outputs of every op. Views and
    metadata ops count zero (the twin of ``_SKIP_BYTES_OPS``); a slice read
    through an index (``index``, ``index_select``, ``gather``,
    ``embedding``) counts 2x the slice, and an index-copy (``copy_``,
    ``index_put_``, ``scatter``, ``slice_scatter``, ...) 2x what it writes,
    as ``line_bytes`` counts dynamic slices and updates;
  * ``bytes_min``: only the products, the collectives' buffers, the slices
    and index-copies, and the kernel ops;
  * ``collectives``: wire bytes by kind under the reference's names, the
    larger of a collective's result and its operands times the ring factor
    of ``WIRE_FACTOR``; as in ``hlo.py`` a collective adds its buffer to
    ``bytes_min`` and nothing to ``bytes``. Both the functional collectives
    that DTensor's redistributions issue (``_c10d_functional.*``) and the
    explicit ones (``c10d.*``: the decode merge's all-reduces, the MoE
    ``all_to_all``, ``parallel.local.dense``) are caught.
    ``total_native`` equals ``total``: the reference corrects for XLA:CPU
    widening bf16 collectives to f32, and an eager step moves each
    collective's buffer at its own dtype;
  * ``top_ops`` and ``top_dots``: the 12 largest collectives and products,
    with the op's name and its shapes in place of HLO text.

A hand-written kernel is one op, counted by its own formula (the
``*_cost`` functions beside each op in ``kernels/<name>/ops.py``) on every
device: the ops call :func:`kernel_op` where they pick the kernel or its
plain version, and the aten ops beneath (the plain version's on the CPU or
on ``meta`` tensors, the wrapper's allocations on the card; the launch
itself no dispatch mode sees) are not counted. So one step counts the same
on the card, on the CPU and on ``meta`` tensors.

A DTensor op is left to DTensor, which runs it on the local shards and
issues the collectives its redistributions need; those are what a rank
runs and what the mode counts. Host syncs (``_local_scalar_dense``) and
the wait on a functional collective's result move no bytes of the step's
work and count zero (``ZERO_OPS``). A composite op that reaches the mode
whole (``inference_mode`` skips the autograd keys that decompose it) is
decomposed there, so a step counts the same in every grad mode.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from contextlib import nullcontext
from typing import Dict, List, NamedTuple, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

WIRE_FACTOR = {
    "all-gather": 1.0,
    "all-reduce": 2.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

#: collective op name (functional and c10d) -> the reference's kind
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
}

#: ops that move none of the step's bytes: allocation, metadata, host syncs
ZERO_OPS = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "lift_fresh", "_local_scalar_dense", "wait_tensor",
    "_wrap_tensor_autograd",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "set_",
    "resize_", "is_same_size", "_has_compatible_shallow_copy_type",
})

#: products: op name -> the index of the argument whose last dim (or, for a
#: convolution, whose in-channels x kernel extent) is contracted
DOTS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1, "convolution": 1}

#: slice reads through an index: 2x the result
SLICE_READS = frozenset({"index", "index_select", "gather", "embedding",
                         "take_along_dim"})
#: index-copies: op name -> the argument they write (2x its bytes)
INDEX_COPIES = {"index_put_": 2, "index_put": 2, "_index_put_impl_": 2,
                "index_copy_": 3, "index_copy": 3, "index_add_": 3, "index_add": 3,
                "scatter_": 3, "scatter": 3, "scatter_add_": 3, "scatter_add": 3,
                "scatter_reduce_": 3, "scatter_reduce": 3, "slice_scatter": 1,
                "select_scatter": 1, "masked_scatter_": 2, "masked_scatter": 2}

TOP = 12
#: the reference's TPU scans keep their chunk-start states every 64 steps
#: (B4-B7's default chunk); the port's kernels keep them every 8, its own
#: design, so a scan's counted bytes hold them at the reference's interval
REF_CHUNK = 64


class Cost(NamedTuple):
    """A kernel op's work: its operations and the bytes it moves (each
    input read once, each output written once)."""

    flops: float
    bytes: float


def nbytes(shape, dtype) -> int:
    """Bytes of a tensor of ``shape`` and ``dtype``."""
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def tensor_bytes(*tensors) -> int:
    """Bytes of the tensors (``None`` counts zero)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def ref_chunk_bytes(B, H, S, row_floats) -> int:
    """f32 bytes of one row of ``row_floats`` per (b, h) and ``REF_CHUNK``
    steps: the chunk-start states (and du partials) the replaced TPU scan
    keeps at its default chunk."""
    return B * H * -(-S // REF_CHUNK) * row_floats * 4


def acc_dtype(t) -> torch.dtype:
    """The dtype a kernel op accumulates and returns f32 results in: f64
    for f64 inputs (the plain versions' float64 path), else f32."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _sum_bytes(x) -> int:
    """Bytes of the tensors in ``x``: a tensor, or lists, tuples and dicts
    of them (anything else counts zero)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_sum_bytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_sum_bytes(v) for v in x.values())
    return 0


def _shapes(args) -> List[Tuple[int, ...]]:
    return [tuple(t.shape) for t in tree_leaves(args) if isinstance(t, torch.Tensor)]


_COMPOSITE = torch._C.DispatchKey.CompositeImplicitAutograd


def _rule(func) -> Tuple:
    """How an op counts: (its name in ``by_op``, its rule, the rule's
    argument, the op's name, whether it has a composite decomposition)."""
    name = func._overloadpacket.__name__
    composite = torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), _COMPOSITE)
    if name in COLLECTIVES:
        how, arg = "collective", COLLECTIVES[name]
    elif name in ZERO_OPS or func.is_view:
        how, arg = "zero", None
    elif name in DOTS:
        how, arg = "dot", DOTS[name]
    elif name in SLICE_READS:
        how, arg = "slice", None
    elif name in INDEX_COPIES:
        how, arg = "index_copy", INDEX_COPIES[name]
    elif name == "copy_":
        how, arg = "copy", None
    else:
        how, arg = "other", None
    return str(func), how, arg, name, composite


_ACTIVE: List["CostMode"] = []


class _Hidden:
    """The span of one kernel op under the active modes."""

    def __init__(self, modes, name, cost):
        self.modes, self.name, self.cost = modes, name, cost

    def __enter__(self):
        for m in self.modes:
            m._record_kernel(self.name, self.cost)
            m._hidden += 1

    def __exit__(self, *exc):
        for m in self.modes:
            m._hidden -= 1


def kernel_op(name: str, cost_fn, *args, **kwargs):
    """A context around the hand-written kernel op ``name``: every active
    :class:`CostMode` counts it once, by ``cost_fn(*args, **kwargs)`` (a
    :class:`Cost`), and none of the aten ops run inside. Without an active
    mode it does nothing and computes nothing."""
    if not _ACTIVE:
        return nullcontext()
    return _Hidden(list(_ACTIVE), name, cost_fn(*args, **kwargs))


class CostMode(TorchDispatchMode):
    """Counts the ops of the code run under it (see the module docstring);
    :meth:`summary` gives the totals under the reference's names."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.bytes_min = 0.0
        self.collectives: Dict[str, float] = defaultdict(float)
        self.collective_counts: Counter = Counter()
        self.kernel_calls: Counter = Counter()
        #: op name -> [calls, flops, bytes]: where a count comes from
        self.by_op: Dict[str, list] = defaultdict(lambda: [0, 0.0, 0.0])
        self._top_ops: List[Tuple[float, str, str, list]] = []
        self._top_dots: List[Tuple[float, str, list]] = []
        self._hidden = 0
        self._depth = 0
        self._rules: Dict[object, Tuple] = {}
        from torch.distributed.tensor import DTensor

        self._dtensor = DTensor

    def __enter__(self):
        self._depth += 1
        if self._depth == 1:
            _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def _record_kernel(self, name: str, cost: Cost) -> None:
        if self._hidden:  # a kernel op inside another's plain version
            return
        self.kernel_calls[name] += 1
        self._by_op(name, cost.flops, cost.bytes)
        self.flops += cost.flops
        self.bytes += cost.bytes
        self.bytes_min += cost.bytes
        self._top_dots.append((float(cost.flops), name, []))

    def _by_op(self, name, flops, n_bytes):
        row = self.by_op[name]
        row[0] += 1
        row[1] += flops
        row[2] += n_bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented  # DTensor runs it on the local shards
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        rule = self._rules.get(func)
        if rule is None:
            rule = self._rules[func] = _rule(func)
        if rule[4]:
            # a composite op (``linear``, ``matmul``, ``einsum``, ``to``)
            # reaches the mode whole under ``inference_mode``; its parts
            # are what runs, so they are what counts, in every grad mode
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if not self._hidden:
            self._count(rule, args, kwargs, out)
        return out

    def _count(self, rule, args, kwargs, out) -> None:
        op, how, arg, name, _ = rule
        if how == "zero":
            self._by_op(op, 0.0, 0.0)
            return
        if how == "collective":
            best = max([_sum_bytes(out)] + [_sum_bytes(a) for a in args])
            wire = best * WIRE_FACTOR[arg]
            self.collectives[arg] += wire
            self.collective_counts[name] += 1
            self.bytes_min += best
            self._by_op(op, 0.0, best)
            self._top_ops.append((wire, arg, op, _shapes(args)))
            return
        flops = 0.0
        if how == "dot":
            a = args[arg]
            # K: the contracted extent (a convolution's in-channels / groups
            # times its kernel extent)
            k = math.prod(a.shape[1:]) if name == "convolution" else a.shape[-1]
            flops = 2.0 * out.numel() * k
            b = _sum_bytes(args) + _sum_bytes(out)
            self._top_dots.append((flops, op, _shapes(args)))
        elif how == "slice":
            b = 2 * _sum_bytes(out)
        elif how == "index_copy":
            b = 2 * _sum_bytes(args[arg])
        elif how == "copy":
            b = _sum_bytes(args[0]) + _sum_bytes(args[1])
        else:
            b = _sum_bytes(args) + _sum_bytes(kwargs) + _sum_bytes(out)
            self.bytes += b
            self._by_op(op, 0.0, b)
            return
        self.flops += flops
        self.bytes += b
        self.bytes_min += b
        self._by_op(op, flops, b)

    def summary(self) -> Dict[str, object]:
        """The counts under the reference dry-run's names."""
        total = float(sum(self.collectives.values()))
        top_ops = sorted(self._top_ops, key=lambda t: -t[0])[:TOP]
        top_dots = sorted(self._top_dots, key=lambda t: -t[0])[:TOP]
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "bytes_min": self.bytes_min,
            "collectives": {
                **{k: self.collectives[k] for k in WIRE_FACTOR if k in self.collectives},
                "total": total, "total_native": total,
                "top_ops": [{"bytes": b, "op": kind, "name": op, "shapes": sh}
                            for b, kind, op, sh in top_ops]},
            "collective_counts": dict(sorted(self.collective_counts.items())),
            "kernel_calls": dict(sorted(self.kernel_calls.items())),
            "top_dots": [{"flops": f, "op": op, "shapes": sh} for f, op, sh in top_dots],
        }

    def totals(self) -> Dict[str, object]:
        """What two runs of one step must agree on: flops, bytes,
        ``bytes_min``, collective bytes by kind and the kernel calls."""
        return {"flops": self.flops, "bytes": self.bytes, "bytes_min": self.bytes_min,
                "collectives": dict(sorted(self.collectives.items())),
                "kernel_calls": dict(sorted(self.kernel_calls.items()))}
