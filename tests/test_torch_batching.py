"""Port ``ContinuousBatcher`` against the reference batcher on the CPU.

Greedy tokens of the port (plain PyTorch path) equal the reference's, with
the reference on its jnp path (``use_pallas=False``) and on its Pallas
kernels in interpret mode (``use_pallas=True``), for the dense, paged and
paged-int8 layouts on the starcoder2 and gemma2 smoke configs, and for the
dense layout on the rwkv6-3b smoke config (whose paged layouts raise in both
batchers). Also: port dense == port paged; RWKV state bytes; the decode_scale capacity claim (8 resident paged slots
vs 2 dense at an 8-block budget); the int8 pool bytes ratio; the
prefill-bucket count; the port's copy of ``PageAllocator``; the default
device.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.obs.metrics import REGISTRY  # noqa: E402
from repro.runtime.batching import ContinuousBatcher as JBatcher  # noqa: E402
from repro.runtime.batching import GenRequest as JRequest  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import LAUNCHES, PLAIN_CALLS, reset_counts  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime.batching import ContinuousBatcher, GenRequest  # noqa: E402
from repro_torch.runtime.paging import (NULL_BLOCK, TRASH_BLOCK,  # noqa: E402
                                        PageAllocator, PagedCacheOOM, pages_needed)

# (prompt length, max_new): mixed lengths across the 16/32/64 buckets
SHAPES = [(8, 6), (5, 9), (12, 7), (15, 5), (3, 12), (40, 6)]
# RWKV: exact-length prefill, 64 on the reference's Pallas scan, 37 off it
RWKV_SHAPES = [(5, 6), (64, 6), (37, 6), (128, 6)]
RWKV_MAX_LEN = 160
LAYOUTS = {"dense": dict(kv_layout="dense"), "paged": dict(kv_layout="paged"),
           "int8": dict(kv_layout="paged", kv_quant="int8")}
_CACHE = {}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Run this module's torch ops on one thread, as tests/test_torch_mamba.py
    does: with other test processes on every core, torch's intra-op pool
    waits at each small eager op for descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(vocab, shapes=SHAPES, seed=42):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, p).astype(np.int32), m) for p, m in shapes]


def _reference(arch, use_pallas):
    key = (arch, use_pallas)
    if key not in _CACHE:
        cfg = j_smoke(arch).replace(use_pallas=use_pallas)
        model = j_build(cfg)
        _CACHE[key] = (model, model.init(jax.random.PRNGKey(0)))
    return _CACHE[key]


def _port(arch):
    key = ("port", arch)
    if key not in _CACHE:
        _, jparams = _reference(arch, False)
        cfg = smoke_config(arch)
        _CACHE[key] = (build_model(cfg), params_from_jax(
            jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
    return _CACHE[key]


def _run_port(arch, layout, shapes=SHAPES, **kw):
    model, params = _port(arch)
    b = ContinuousBatcher(model, params, device="cpu", **{
        **dict(max_slots=2, max_len=64), **LAYOUTS[layout], **kw})
    reqs = [GenRequest(i, p, m) for i, (p, m) in
            enumerate(_prompts(model.cfg.vocab_size, shapes))]
    for r in reqs:
        b.submit(r)
    b.run()
    assert all(r.finish_step is not None for r in reqs)
    if layout != "dense":
        b.allocator.check_conservation()
        assert b.allocator.n_free == b.allocator.n_allocatable
    return b, [r.tokens for r in reqs]


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ["starcoder2-3b", "gemma2-2b", "rwkv6-3b"])
def test_port_tokens_match_reference_batcher(arch, layout, use_pallas):
    model, params = _reference(arch, use_pallas)
    rwkv = arch == "rwkv6-3b"
    shapes, max_len = (RWKV_SHAPES, RWKV_MAX_LEN) if rwkv else (SHAPES, 64)
    if rwkv and layout != "dense":  # RWKV state is not paged, in either batcher
        with pytest.raises(NotImplementedError):
            JBatcher(model, params, max_slots=2, max_len=max_len, **LAYOUTS[layout])
        with pytest.raises(NotImplementedError):
            _run_port(arch, layout, shapes, max_len=max_len)
        return
    jb = JBatcher(model, params, max_slots=2, max_len=max_len, **LAYOUTS[layout])
    jreqs = [JRequest(i, p, m) for i, (p, m) in
             enumerate(_prompts(model.cfg.vocab_size, shapes))]
    for r in jreqs:
        jb.submit(r)
    jb.run()
    reset_counts()
    _, tokens = _run_port(arch, layout, shapes, max_len=max_len)
    assert tokens == [r.tokens for r in jreqs]
    # on the CPU every kernel op ran its plain version, no kernel
    assert sum(LAUNCHES.values()) == 0
    if rwkv:
        assert PLAIN_CALLS["rwkv6_scan"] > 0
        return
    assert PLAIN_CALLS["flash_attention"] > 0
    name = "decode_attention" if layout == "dense" else "paged_decode_attention"
    assert PLAIN_CALLS[name] > 0


def test_rwkv_state_bytes_equal_reference():
    """Dense RWKV slots hold (shift_tm, shift_cm, wkv) per layer: 2 slots x
    2 layers x (2 x 128 + 4 x 32 x 32) f32 = 69632 bytes in both batchers."""
    jmodel, jparams = _reference("rwkv6-3b", False)
    model, params = _port("rwkv6-3b")
    jb = JBatcher(jmodel, jparams, max_slots=2, max_len=RWKV_MAX_LEN)
    b = ContinuousBatcher(model, params, max_slots=2, max_len=RWKV_MAX_LEN,
                          device="cpu")
    assert b.kv_cache_bytes() == jb.kv_cache_bytes() == 69632


@pytest.mark.parametrize("arch", ["starcoder2-3b", "gemma2-2b"])
def test_port_dense_equals_port_paged(arch):
    _, dense = _run_port(arch, "dense")
    _, paged = _run_port(arch, "paged", kv_block_size=16)
    assert dense == paged


def test_paged_capacity_eight_slots_vs_two_dense():
    """decode_scale's capacity claim on the port: 8 blocks of 16 tokens (the
    memory of two dense max_len=64 slots) hold 8 resident 1-page requests."""
    model, params = _port("starcoder2-3b")
    b = ContinuousBatcher(model, params, max_slots=8, max_len=64,
                          kv_layout="paged", kv_blocks=8, device="cpu")
    rng = np.random.default_rng(3)
    reqs = [GenRequest(i, rng.integers(1, 512, 8).astype(np.int32), 8)
            for i in range(12)]
    for r in reqs:
        b.submit(r)
    peak = 0
    while b.queue or b.slots.n_active:
        peak = max(peak, b.step())
    b.allocator.check_conservation()
    assert all(r.finish_step is not None for r in reqs)
    dense_slots = 8 // (64 // 16)
    assert (peak, dense_slots) == (8, 2)


def test_int8_pool_bytes_ratio_equals_reference():
    jmodel, jparams = _reference("starcoder2-3b", False)
    model, params = _port("starcoder2-3b")
    ratios = []
    for make, kw in ((lambda **k: JBatcher(jmodel, jparams, **k), {}),
                     (lambda **k: ContinuousBatcher(model, params, **k),
                      dict(device="cpu"))):
        b8 = make(max_slots=2, max_len=64, kv_layout="paged", kv_quant="int8", **kw)
        b32 = make(max_slots=2, max_len=64, kv_layout="paged", **kw)
        ratios.append(b32.kv_cache_bytes() / b8.kv_cache_bytes())
    assert ratios[0] == ratios[1]
    assert ratios[1] > 1 / 0.35


def test_prefill_bucket_count_matches_reference():
    jmodel, jparams = _reference("starcoder2-3b", False)
    model, params = _port("starcoder2-3b")
    jb = JBatcher(jmodel, jparams, max_slots=2, max_len=64, prompt_bucket=16)
    b = ContinuousBatcher(model, params, max_slots=2, max_len=64,
                          prompt_bucket=16, device="cpu")
    counter = REGISTRY.counter("batcher.prefill_compiles")
    before = counter.value
    # five distinct lengths in bucket 16, two in bucket 32
    for batcher, make in ((jb, JRequest), (b, GenRequest)):
        for i, plen in enumerate((3, 5, 8, 11, 15, 17, 25)):
            batcher.submit(make(i, np.arange(1, plen + 1, dtype=np.int32), 3))
        batcher.run()
    assert b.prefill_compiles == counter.value - before == 2
    assert sorted(b._prefills) == sorted(jb._prefills) == [16, 32]


def test_paged_head_of_line_and_submit_oom():
    model, params = _port("starcoder2-3b")
    b = ContinuousBatcher(model, params, max_slots=4, max_len=64,
                          kv_layout="paged", kv_blocks=2, device="cpu")
    with pytest.raises(PagedCacheOOM):  # needs 4 pages, the pool holds 2
        b.submit(GenRequest(9, np.arange(1, 41, dtype=np.int32), 30))
    with pytest.raises(ValueError):
        b.submit(GenRequest(8, np.arange(1, 65, dtype=np.int32), 1))
    reqs = [GenRequest(i, np.arange(1, 9, dtype=np.int32), 6) for i in range(5)]
    for r in reqs:
        b.submit(r)  # one page each: at most two resident at a time
    peak = 0
    while b.queue or b.slots.n_active:
        peak = max(peak, b.step())
    assert peak == 2 and all(r.finish_step is not None for r in reqs)
    b.allocator.check_conservation()


def test_page_allocator_copy_conservation_random_walk():
    rng = np.random.default_rng(0)
    alloc = PageAllocator(n_blocks=18, block_size=8, max_slots=6,
                          pages_per_slot=4)
    held = {}
    for _ in range(500):
        if held and rng.random() < 0.45:
            slot = rng.choice(sorted(held))
            alloc.free(slot)
            del held[slot]
        else:
            slot = int(rng.integers(0, 6))
            n = int(rng.integers(1, 5))
            if slot in held:
                with pytest.raises(RuntimeError):
                    alloc.reserve(slot, n)
            elif n > alloc.n_free:
                with pytest.raises(PagedCacheOOM):
                    alloc.reserve(slot, n)
            else:
                row = alloc.reserve(slot, n)
                held[slot] = n
                assert not np.isin(row[:n], (NULL_BLOCK, TRASH_BLOCK)).any()
                assert (row[n:] == NULL_BLOCK).all()
        alloc.check_conservation()
    for slot in sorted(held):
        alloc.free(slot)
    alloc.check_conservation()
    assert (alloc.table == TRASH_BLOCK).all()
    assert pages_needed(8, 9, 64, 16) == 2 and pages_needed(60, 100, 64, 16) == 4


@pytest.mark.parametrize("arch", ["starcoder2-3b", "rwkv6-3b"])
def test_dropped_batcher_is_freed_without_the_cycle_collector(arch):
    """Nothing the batcher builds (its prefill closures included) refers
    back to it, so dropping it frees its caches at once."""
    model, params = _port(arch)
    b = ContinuousBatcher(model, params, max_slots=2, max_len=64, device="cpu")
    b.submit(GenRequest(0, np.arange(1, 9, dtype=np.int32), 3))
    b.run()
    assert b._prefills
    ref = weakref.ref(b)
    gc.disable()
    try:
        del b
        assert ref() is None
    finally:
        gc.enable()


def test_batcher_defaults_to_cuda():
    model, params = _port("starcoder2-3b")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="cuda"):
        ContinuousBatcher(model, params)
