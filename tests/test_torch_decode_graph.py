"""The paged decode step replayed as one CUDA graph
(``DecoderLM.decode_step_paged``): on the card, a batcher's steps with the
graph against the same steps forced eager, on the benchmark's tiny dense
(GQA, local window) and MoE (capacity dispatch) fixtures and on an int8
pool: the same tokens, bitwise the same logits and routing of the active
slots, one fresh routing record a MoE layer and step, the same kernel
launch counts, the spans of each mode; two batchers stepping in turn on
one model; a dropped batcher's pools freed; DTensor and CPU calls never
captured. The CPU cases (no marker) hold the eager path to what it did
before the graph and the graph's key to the tensors it was made on.

The ``gpu`` cases need a CUDA device and ``nvcc``; the ``cuda`` fixture
skips them otherwise (decided inside the fixture, never at import). Run on
the card with::

    PYTHONPATH=src python -m pytest -q tests/test_torch_decode_graph.py
"""

import gc
import pathlib
import sys
import weakref

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.conftest import DENSE, MOE  # noqa: E402
from perfbench.harness import model_config  # noqa: E402
from repro_torch.kernels import LAUNCHES, PLAIN_CALLS, reset_counts  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.models.decoder import DecoderLM, _GraphSlot  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.runtime.batching import ContinuousBatcher, GenRequest  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths  # noqa: E402

CASES = {"dense": (DENSE, None), "moe": (MOE, None), "int8": (DENSE, "int8")}


def _on_card(config):
    """The fixture at a head size the kernels are built for (32)."""
    return dict(config, model=dict(config["model"], head_dim=32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graph captures the card's kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def record():
    """``mlp.RECORD`` on for the test, off after it."""
    mlp.RECORD = []
    try:
        yield mlp.RECORD
    finally:
        mlp.RECORD = None


def _params(config, device):
    model = DecoderLM(model_config(config))
    return model.init(torch.Generator(device=device).manual_seed(7), device=device)


def _requests(n=12, seed=3):
    rng = np.random.default_rng(seed)
    return [GenRequest(rid=100 + i, prompt=rng.integers(1, 256, int(rng.integers(8, 60)))
                       .astype(np.int32), max_new=int(rng.integers(4, 15))) for i in range(n)]


class _Steps:
    """A batcher over its own ``DecoderLM`` whose decode calls are kept:
    each step's active slots, logits and the routing records it appended."""

    def __init__(self, config, params, device, quant=None, model=None, tracer=None):
        self.model = model or DecoderLM(model_config(config), tracer=tracer)
        self.batcher = ContinuousBatcher(
            self.model, params, max_slots=4, max_len=128, kv_layout="paged",
            kv_block_size=16, kv_quant=quant, device=device)
        self.active, self.logits, self.routes = [], [], []
        self.batcher.model = self  # the batcher calls decode_step_paged here

    def __getattr__(self, name):
        return getattr(self.model, name)

    def decode_step_paged(self, params, pools, **kw):
        mark = None if mlp.RECORD is None else len(mlp.RECORD)
        self.active.append([i for i, _ in self.batcher.slots.items()])
        out = self.model.decode_step_paged(params, pools, **kw)
        self.logits.append(out[0].clone())
        if mark is not None:
            self.routes.append(mlp.RECORD[mark:])
        return out

    def serve(self, reqs, per_step=1):
        """Submit ``per_step`` requests before each step; returns the
        requests' tokens once every request finished."""
        pending = list(reqs)
        b = self.batcher
        while pending or b.queue or b.slots.n_active:
            for _ in range(min(per_step, len(pending))):
                b.submit(pending.pop(0))
            b.step()
        return [list(r.tokens) for r in reqs]


def _eager(monkeypatch):
    monkeypatch.setattr(DecoderLM, "_graph_slot", lambda self, *a: None)


def _same_steps(a: _Steps, b: _Steps):
    """Each step's active rows bitwise: logits, and each MoE layer's
    choices, probabilities and kept assignments. A free slot decodes
    garbage over the TRASH block (``runtime.paging``), which differs from
    run to run even on the eager path, so its rows are not compared."""
    assert a.active == b.active
    assert len(a.logits) == len(b.logits) == len(a.routes) == len(b.routes)
    for rows, x, y, ea, eb in zip(a.active, a.logits, b.logits, a.routes, b.routes):
        assert torch.equal(x[rows], y[rows])
        assert len(ea) == len(eb)
        for (ia, pa, ka), (ib, pb, kb) in zip(ea, eb):
            assert torch.equal(ia[0, rows], ib[0, rows])
            assert torch.equal(pa[0, rows], pb[0, rows])
            k = ia.shape[-1]
            assert (ka is None and kb is None) or torch.equal(
                ka[0].reshape(-1, k)[rows], kb[0].reshape(-1, k)[rows])


def _distinct(routes):
    """No two steps' records share a tensor: each is the step's own copy."""
    ptrs = [t.data_ptr() for step in routes for entry in step for t in entry
            if t is not None]
    assert len(ptrs) == len(set(ptrs))


# ------------------------------------------------------------------- card


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_steps_equal_eager_steps(cuda, record, monkeypatch, case):
    config, quant = CASES[case]
    config = _on_card(config)
    params = _params(config, cuda)
    runs = {}
    for mode in ("graph", "eager"):
        if mode == "eager":
            _eager(monkeypatch)
        reset_counts()
        record.clear()
        tr = Tracer()
        run = _Steps(config, params, cuda, quant, tracer=tr)
        tokens = run.serve(_requests())
        torch.cuda.synchronize()
        runs[mode] = (run, tokens, dict(LAUNCHES), tr)
    (g, g_tok, g_launch, g_tr), (e, e_tok, e_launch, _) = runs["graph"], runs["eager"]
    n = len(g.logits)
    assert n >= 20
    assert g_tok == e_tok
    _same_steps(g, e)
    assert g_launch == e_launch
    assert g_launch["paged_decode_attention"] == n * config["model"]["num_layers"]
    assert (g.model.decode_graph_captures, g.model.decode_graph_replays) == (1, n - 1)
    assert (e.model.decode_graph_captures, e.model.decode_graph_replays) == (0, 0)
    if case == "moe":
        assert all(len(step) == config["model"]["num_layers"] for step in g.routes)
        _distinct(g.routes)
    spans = {ev["args"]["id"]: ev for ev in g_tr.events if ev["ph"] == "X"}
    steps = [ev for ev in spans.values() if ev["name"] == "model.decode_step"]
    assert [ev["args"]["graph"] for ev in steps] == ["eager", "capture"] + ["replay"] * (n - 2)
    layers = {}
    for ev in spans.values():
        if ev["name"] == "model.layer":
            layers[ev["args"]["parent"]] = layers.get(ev["args"]["parent"], 0) + 1
    for ev in steps:
        want = 0 if ev["args"]["graph"] == "replay" else config["model"]["num_layers"]
        assert layers.get(ev["args"]["id"], 0) == want


@pytest.mark.gpu
def test_two_batchers_in_turn_each_keep_their_graph(cuda, record, monkeypatch):
    moe = _on_card(MOE)
    params = _params(moe, cuda)
    runs = {}
    for mode in ("graph", "eager"):
        if mode == "eager":
            _eager(monkeypatch)
        record.clear()
        model = DecoderLM(model_config(moe))
        a = _Steps(moe, params, cuda, model=model)
        b = _Steps(moe, params, cuda, model=model)
        queues = [list(_requests(seed=3)), list(_requests(seed=4))]
        reqs = [list(q) for q in queues]
        while any(q or s.batcher.queue or s.batcher.slots.n_active
                  for q, s in zip(queues, (a, b))):
            for q, s in zip(queues, (a, b)):
                if q:
                    s.batcher.submit(q.pop(0))
                if s.batcher.queue or s.batcher.slots.n_active:
                    s.batcher.step()
        torch.cuda.synchronize()
        runs[mode] = (model, a, b, [[list(r.tokens) for r in rs] for rs in reqs])
    gm, ga, gb, g_tok = runs["graph"]
    em, ea, eb, e_tok = runs["eager"]
    assert g_tok == e_tok
    _same_steps(ga, ea)
    _same_steps(gb, eb)
    assert gm.decode_graph_captures == 2
    assert gm.decode_graph_replays == len(ga.logits) + len(gb.logits) - 2
    assert len(gm._decode_graphs) == 2
    _distinct(ga.routes + gb.routes)


@pytest.mark.gpu
def test_a_dropped_batcher_frees_its_pools(cuda):
    dense = _on_card(DENSE)
    run = _Steps(dense, _params(dense, cuda), cuda)
    run.serve(_requests(n=4))
    assert run.model.decode_graph_replays > 0
    pool = weakref.ref(run.batcher.pools[0]["k"])
    model = run.model
    del run
    gc.collect()
    assert pool() is None
    assert len(model._decode_graphs) == 1  # the slot lives on, keyed to a dead tensor


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A one-rank NCCL process group and its (1, 1) (data, model) mesh."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield make_smoke_mesh((1, 1), device_type="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_dtensor_decode_never_captures(nccl_mesh):
    """Paged decode of starcoder2's smoke config on the (1, 1) mesh, three
    times on the same pools: every call eager."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.configs import smoke_config
    from repro_torch.parallel import use_sharding_ctx
    from repro_torch.parallel.distribute import distribute_tree
    from repro_torch.parallel.layouts import layout_rules, param_specs, to_shardings

    cfg = smoke_config("starcoder2-3b")
    model = DecoderLM(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    B, bs, P = 4, 8, 4
    pools = model.init_paged_cache(B * P, bs, device="cuda")
    pages = torch.arange(B * P, dtype=torch.int32, device="cuda").reshape(B, P)
    pos = torch.tensor([0, 3, 9, 17], device="cuda")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 1)))
    rules = layout_rules(nccl_mesh, cfg, "decode", global_batch=B)
    with torch.no_grad(), use_sharding_ctx(nccl_mesh, rules):
        dp = distribute_tree(params, to_shardings(param_specs(params, nccl_mesh, rules),
                                                  nccl_mesh))
        t = distribute_tensor(toks.cuda(), nccl_mesh, [Replicate()] * 2, src_data_rank=None)
        for _ in range(3):
            model.decode_step_paged(dp, pools, tokens=t, pos_vec=pos, pages=pages)
    torch.cuda.synchronize()
    assert (model.decode_graph_captures, model.decode_graph_replays) == (0, 0)
    assert not model._decode_graphs


# -------------------------------------------------------------------- CPU


@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_decode_stays_eager(two_threads, record, case):
    """On the CPU every step runs eagerly and records as before: no
    capture, no replay, no graph kept, the plain attention once a layer
    and step, no kernel launch, one routing entry a MoE layer and call,
    and the ``model.decode_step`` span marked eager with its layers
    inside."""
    config, quant = CASES[case]
    cpu = torch.device("cpu")
    reset_counts()
    tr = Tracer()
    run = _Steps(config, _params(config, cpu), cpu, quant, tracer=tr)
    run.serve(_requests(n=5))
    n, layers = len(run.logits), config["model"]["num_layers"]
    assert n > 2
    assert (run.model.decode_graph_captures, run.model.decode_graph_replays) == (0, 0)
    assert not run.model._decode_graphs
    assert sum(LAUNCHES.values()) == 0
    assert PLAIN_CALLS["paged_decode_attention"] == n * layers
    want = layers if config is MOE else 0
    assert all(len(step) == want for step in run.routes)
    steps = [ev for ev in tr.events if ev["ph"] == "X" and ev["name"] == "model.decode_step"]
    assert [ev["args"]["graph"] for ev in steps] == ["eager"] * n
    n_layer = sum(1 for ev in tr.events if ev["ph"] == "X" and ev["name"] == "model.layer")
    assert n_layer == layers * (n + 5)  # every decode step and each request's prefill


def test_graph_slot_holds_only_the_tensors_it_was_made_on():
    """The key's weak references and pointers: the same tensors match; a
    copy, a tensor moved to another storage or a dead one does not."""
    ts = [torch.zeros(4), torch.ones(2, 3)]
    slot = _GraphSlot(ts)
    assert slot.holds(ts)
    assert not slot.holds([ts[0], ts[1].clone()])
    ts[1].set_(torch.ones(2, 3))
    assert not slot.holds(ts)
    slot = _GraphSlot(ts)
    ref = weakref.ref(ts[1])
    del ts
    gc.collect()
    assert ref() is None and slot.refs[1]() is None


def test_leaves_in_path_order():
    model = DecoderLM(model_config(MOE))
    tree = (model.init_shape(), model.init_paged_cache(4, 16, device="meta"))
    assert [id(t) for t in leaves(tree)] == [id(t) for _, t in leaves_with_paths(tree)]
