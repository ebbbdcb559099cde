"""The port's twins of the JAX package's ``examples/quickstart.py`` and
``examples/trace_replay.py`` print the reference's stdout, line for line,
at quick scale (both run the DES on the host); and ``chip_smoke.py``'s
golden copies of that stdout, which the chip machine (no JAX) holds the
twins to, equal fresh reference runs."""

import pathlib
import runpy
import sys

import pytest

from repro_torch.examples import quickstart, trace_replay

ROOT = pathlib.Path(__file__).resolve().parents[1]
TWINS = {"quickstart": quickstart, "trace_replay": trace_replay}


def _reference_stdout(name, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    runpy.run_path(str(ROOT / "examples" / f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out


@pytest.mark.parametrize("name,argv", [
    ("quickstart", []),
    ("trace_replay", []),
    ("trace_replay", ["--scenarios", "eagle,coaster_r3", "--burst-mult", "3"]),
], ids=["quickstart", "trace_replay", "trace_replay_two_presets_burst3"])
def test_twin_prints_the_reference_stdout(name, argv, capsys, monkeypatch):
    capsys.readouterr()
    ref = _reference_stdout(name, argv, capsys, monkeypatch)
    TWINS[name].main(argv)
    port = capsys.readouterr().out
    assert ref.count("\n") >= 7
    assert port.splitlines() == ref.splitlines()


def test_chip_smoke_example_goldens_equal_fresh_reference_runs(capsys, monkeypatch):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert sorted(chip_smoke.EXAMPLES_GOLDEN) == sorted(TWINS)
    capsys.readouterr()
    for name, golden in chip_smoke.EXAMPLES_GOLDEN.items():
        assert _reference_stdout(name, [], capsys, monkeypatch) == golden, name
