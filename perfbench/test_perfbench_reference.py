"""Each configuration is judged by the reference its ``"reference"`` key
names: a stub named there judges the run, a missing file or one without
``Ref`` stops the run before it builds anything, and the default file
loaded by its path judges exactly as the module imported."""

import pytest

from perfbench import harness
from perfbench.conftest import CLOSED, DENSE, MOE, OPEN
from perfbench.reference import decoder

STUB = '''
import torch


class Ref:
    """Puts token 0 first by 7 at every position, whatever was served."""

    def __init__(self, m, params, quant=None):
        self.m = m

    def forward(self, tokens, n_prompt, routes=None):
        logits = torch.zeros((tokens.shape[0] - n_prompt + 1, self.m["vocab_size"]),
                             device=tokens.device)
        logits[:, 0] = 7.0
        out = {"logits": logits}
        if self.m.get("num_experts"):
            out.update(routed_off_tie=0, route_gap_max=0.0, keep_mismatch=0)
        return out
'''


def test_reference_named_by_the_configuration_judges(tiny, tmp_path):
    stub = tmp_path / "stub_reference.py"
    stub.write_text(STUB)
    result, run = tiny(dict(DENSE, reference=str(stub)), OPEN)
    assert run.Ref.__doc__.startswith("Puts token 0 first")
    served = {t for s in harness.sample(run) for t in s.req.tokens}
    assert served != {0}
    assert result["checks"]["logit_gap"]["value"] == 7.0
    assert result["correct"] is False


@pytest.mark.parametrize("text,error", [(None, FileNotFoundError),
                                        ("REF = None\n", ImportError)])
def test_reference_missing_stops_before_serving(tiny, tmp_path, monkeypatch, text, error):
    path = tmp_path / "reference.py"
    if text is not None:
        path.write_text(text)

    def build(self):
        raise AssertionError("built a replica")

    monkeypatch.setattr(harness.Run, "build", build)
    with pytest.raises(error, match="reference"):
        tiny(dict(DENSE, reference=str(path)), OPEN)


def test_reference_key_is_relative_to_the_repo_root():
    """Without the key and with the default named, the file is the one the
    package imports, loaded by its path."""
    import inspect

    for config in ({"name": "x"}, {"name": "x", "reference": harness.DEFAULT_REFERENCE}):
        ref = harness.load_reference(config)
        assert ref is not decoder.Ref
        assert inspect.getfile(ref) == inspect.getfile(decoder.Ref)


@pytest.mark.parametrize("config,traffic", [(DENSE, OPEN), (MOE, CLOSED)])
def test_judge_same_by_key_and_by_import(tiny, config, traffic):
    """The numbers compared are identical whether the reference comes by
    the configuration's key or by the old import."""
    _, run = tiny(dict(config, reference=harness.DEFAULT_REFERENCE), traffic)
    assert run.Ref is not decoder.Ref
    by_key = harness.judge(run)
    run.Ref = decoder.Ref
    assert harness.judge(run) == by_key
    assert by_key["tokens_checked"] > 0
