"""A run whose timed path is broken underneath comes out not correct: the
harness, past its look for a card, drives the program on the CPU with one
fault planted in it. (A one-chip cell has no exchange between chips to
leave out.)"""

import pytest

from perfbench.conftest import CLOSED, DENSE, MOE, OPEN


def _unchanged_state(orig):
    """A decode step that leaves the KV pools as it found them."""
    def step(self, params, pools, **kw):
        saved = [{k: v.clone() for k, v in entry.items()} for entry in pools]
        out = orig(self, params, pools, **kw)
        for entry, old in zip(pools, saved):
            for k, v in old.items():
                entry[k].copy_(v)
        return out
    return step


def _half_batch(orig):
    """A decode step that computes half of the slots and gives the rest
    the mean of those."""
    def step(self, params, pools, **kw):
        logits, pools = orig(self, params, pools, **kw)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[h:] = logits[:h].float().mean(0).to(logits.dtype)
        return logits, pools
    return step


def _altered_token(orig):
    """A prefill whose first token is altered where it is produced."""
    def prefill(self, params, **kw):
        logits, caches = orig(self, params, **kw)
        return logits.roll(1, dims=-1), caches
    return prefill


@pytest.mark.parametrize("fault,config,traffic", [
    ("decode_step_paged", DENSE, OPEN),
    ("decode_step_paged", MOE, CLOSED),
    ("half_batch", DENSE, CLOSED),
    ("prefill", DENSE, OPEN),
    ("prefill", MOE, OPEN),
])
def test_fault_is_not_correct(tiny, monkeypatch, fault, config, traffic):
    from repro_torch.models.decoder import DecoderLM

    if fault == "decode_step_paged":
        monkeypatch.setattr(DecoderLM, fault, _unchanged_state(DecoderLM.decode_step_paged))
    elif fault == "half_batch":
        monkeypatch.setattr(DecoderLM, "decode_step_paged",
                            _half_batch(DecoderLM.decode_step_paged))
    else:
        monkeypatch.setattr(DecoderLM, fault, _altered_token(DecoderLM.prefill))
    result, _ = tiny(config, traffic)
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["logit_gap"]["value"] > result["checks"]["logit_gap"]["limit"]


def test_wrong_expert_is_not_correct(tiny, monkeypatch):
    """A router that sends the second assignment of one token in eight to
    the expert it ranks last: far from any near tie, so counted."""
    import torch

    from repro_torch.models import mlp

    orig = mlp._route

    def route(x2, router, k):
        gates, idx, probs = orig(x2, router, k)
        flat = idx.reshape(-1, k).clone()
        flat[::8, -1] = probs.reshape(flat.shape[0], -1).argmin(-1)[::8]
        idx = flat.reshape(idx.shape)
        gates = probs.gather(-1, idx)
        return gates / gates.sum(-1, keepdim=True), idx, probs

    monkeypatch.setattr(mlp, "_route", route)
    result, _ = tiny(MOE, CLOSED)
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["routed_off_tie"]["value"] > 0


def test_route_gap_by_hand():
    import torch

    from perfbench.reference.decoder import route_gap

    logits = torch.tensor([[3.0, 2.0, 1.95, 0.0], [3.0, 2.0, 1.0, 0.0],
                           [3.0, 2.0, 1.0, 0.0], [1.0, 1.04, 0.0, 0.0]])
    idx = torch.tensor([[0, 2], [0, 1], [0, 3], [0, 1]])
    # a near tie broken the other way, the reference's own choice, an
    # expert two below the second left out, the first two swapped
    expect = torch.tensor([0.05, 0.0, 2.0, 0.04])
    assert torch.allclose(route_gap(logits, idx), expect, atol=1e-6)
