"""The seeded weights: the tiny trees' bytes are frozen, every leaf of the
benchmark's configurations takes the rule it took before the Mamba leaves
had their own, and a hybrid tree's Mamba leaves fall in the published
init's ranges."""

import hashlib
import json
import math
import pathlib

import pytest
import torch

from perfbench import harness, weights
from perfbench.conftest import DENSE, MOE

ROOT = pathlib.Path(__file__).resolve().parents[1]

HYBRID = {"name": "tiny-hybrid", "model": {
    "name": "tiny-hybrid", "family": "hybrid", "num_layers": 8, "d_model": 64,
    "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "d_ff": 128, "vocab_size": 256,
    "mixer_pattern": ["mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba"],
    "moe_period": 2, "num_experts": 4, "experts_per_token": 2, "pos_type": "none",
    "mlp_type": "swiglu", "norm_type": "rmsnorm", "ssm_state_dim": 16, "ssm_conv_width": 4,
    "ssm_expand": 2, "tie_embeddings": False, "dtype": "bfloat16",
    "param_dtype": "bfloat16"}}

# sha256 of every leaf's path, dtype and bytes in tree order (the weights
# made before the Mamba leaves had rules of their own)
FROZEN = {
    ("tiny-dense", 0): "91fa84fb07edad966da97913a209f17e7a5ffa010eeef34fb634f531d7f3e6ec",
    ("tiny-dense", 2**31 + 12345):
        "fb522f28738e9121dbeab95f4194103db857f05b2ebd9e4989bf598c787bd781",
    ("tiny-moe", 0): "d8d6ff7ec2f52a3776c48a23514dd2537cea119d8ee70110bcc6e7c72892e9b9",
    ("tiny-moe", 2**31 + 12345):
        "729d3cd79552865a8536c304c8cddcebdb5c3cf44f158ae75d75ab4f9afd3dba",
}


def _shapes(config):
    from repro_torch.models.decoder import DecoderLM

    return DecoderLM(harness.model_config(config)).init_shape()


def _digest(tree) -> str:
    h = hashlib.sha256()
    for path, t in weights._leaves(tree):
        h.update(repr(path).encode())
        h.update(str(t.dtype).encode())
        view = torch.int16 if t.element_size() == 2 else torch.uint8
        h.update(t.contiguous().view(view).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("config,seed", [(c, s) for c in (DENSE, MOE)
                                         for s in (0, 2**31 + 12345)])
def test_tiny_trees_bitwise_frozen(config, seed):
    made = weights.make(_shapes(config), seed, "cpu")
    assert _digest(made) == FROZEN[(config["name"], seed)]


def _old_rule(name, t):
    """The rule every leaf took before the Mamba leaves had their own."""
    if name == "scale":
        return "scale"
    if t.dim() == 1:
        return "bias"
    return "embed" if name == "embed" else "product"


def _new_rule(name, t):
    if name in weights.NORM_SCALES:
        return "scale"
    if name in ("D", "A_log", "dt_bias"):
        return name
    return _old_rule(name, t)


@pytest.mark.parametrize("name", ["starcoder2-3b", "mixtral-8x22b-8of56"])
def test_benchmark_configurations_take_the_old_rules(name):
    """Each leaf of the benchmark's configurations (meta shapes, published
    widths) takes the rule it took before, in the same dtype groups, so
    their seeded weights are bitwise the same."""
    config = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())
    leaves = weights._leaves(_shapes(config))
    assert len(leaves) > 10
    for path, t in leaves:
        assert _new_rule(path[-1], t) == _old_rule(path[-1], t), path


def test_hybrid_mamba_leaves_in_published_ranges():
    shapes = _shapes(HYBRID)
    made = weights.make(shapes, 2**31 + 7, "cpu")
    mixers = [lp["mamba"] for lp in made["layers"] if "mamba" in lp]
    assert len(mixers) == 7
    n = HYBRID["model"]["ssm_state_dim"]
    for p in mixers:
        a = p["A_log"]
        assert a.dtype == torch.float32 and a.shape[-1] == n
        noise = a - torch.log(torch.arange(1, n + 1, dtype=torch.float32))
        assert noise.abs().max() < 0.6 and abs(float(noise.std()) - 0.1) < 0.02
        assert (p["D"] - 1).abs().max() < 0.6 and abs(float(p["D"].mean()) - 1) < 0.05
        dt = torch.nn.functional.softplus(p["dt_bias"])
        assert dt.min() >= 1e-3 * (1 - 1e-4) and dt.max() <= 1e-1 * (1 + 1e-4)
        # log-uniform: log dt spread evenly over [log 1e-3, log 1e-1]
        u = (dt.log() - math.log(1e-3)) / (math.log(1e-1) - math.log(1e-3))
        assert abs(float(u.mean()) - 0.5) < 0.05 and abs(float(u.std()) - 12 ** -0.5) < 0.05
        norms = torch.cat([p[k] for k in ("dt_norm", "b_norm", "c_norm")])
        assert (norms - 1).abs().max() < 0.6 and norms.std() > 0.05
