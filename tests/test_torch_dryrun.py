"""The dry-run twin (``repro_torch.launch.dryrun``) against the reference's
dry-run artifacts (``artifacts/dryrun/{single,multi}/*.json``, 12 cells).

The twin builds each cell on the meta device under the ``"fake"`` process
group at 256 or 512 ranks, which is process-global, so it runs in a
subprocess here. Its static accounting must equal the reference's exactly,
both fresh and as committed under ``artifacts/dryrun_torch/``; and a traced
smoke cell on a fake (2, 4) mesh shows the collectives its layout implies:
``all_to_all`` for expert-parallel MoE cells, ``all_gather`` for FSDP, each
kind with its bytes, beside the reference's other traced fields.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "artifacts" / "dryrun"
TWIN = ROOT / "artifacts" / "dryrun_torch"
CELLS = sorted(str(p.relative_to(REF)) for p in REF.glob("*/*.json"))
FIELDS = ("params", "active_params", "state_bytes_per_device", "tokens_per_step",
          "n_devices", "kind", "layout", "seq_len", "global_batch")


TRACES = {  # the traced smoke cells: (arch, layout) -> (collective shown, one absent)
    ("mixtral-8x22b", None): ("all_to_all_single", None),
    ("jamba-1.5-large-398b", None): ("all_to_all_single", None),
    ("deepseek-coder-33b", "fsdp"): ("all_gather_into_tensor", "all_to_all_single"),
}


def _start(out_dir, *args):
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--force",
         "--out-dir", str(out_dir), *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))


def _wait(proc):
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-6000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every dry-run this module checks, started at once (each is its own
    process: the fake process group is process-global): the cells of the
    reference's artifacts, and the traced smoke cells on a fake (2, 4)
    mesh."""
    out = tmp_path_factory.mktemp("dryrun")
    trains = sorted({c.split("/")[1].split("__")[0] for c in CELLS if "__train_4k" in c})
    procs = {"cells": [
        _start(out, "--arch", ",".join(trains), "--shape", "train_4k", "--mesh", "single"),
        _start(out, "--arch", "deepseek-coder-33b", "--shape", "prefill_32k,decode_32k",
               "--mesh", "both"),
        _start(out, "--arch", "deepseek-coder-33b", "--shape", "train_4k", "--mesh", "multi")]}
    smoke = ["--shape", "train_4k", "--mesh", "single", "--smoke", "--mesh-shape", "2,4",
             "--trace", "--seq", "32", "--batch", "8"]
    for layout in sorted({lay or "" for _, lay in TRACES}):
        archs = [a for a, lay in TRACES if (lay or "") == layout]
        procs[layout] = [_start(out / (layout or "default"), "--arch", ",".join(archs),
                                *smoke, *(["--layout", layout] if layout else []))]
    yield out, procs
    for ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def fresh(runs):
    out, procs = runs
    for p in procs["cells"]:
        _wait(p)
    return out


def test_every_reference_cell_is_covered():
    assert len(CELLS) == 12


@pytest.mark.parametrize("cell", CELLS)
def test_dryrun_twin_reproduces_reference_cell(fresh, cell):
    ref = json.loads((REF / cell).read_text())
    for got in (json.loads((fresh / cell).read_text()),
                json.loads((TWIN / cell).read_text())):
        assert {k: got[k] for k in FIELDS} == {k: ref[k] for k in FIELDS}
        # the port's live trees hold at least the reference's accounting
        assert got["state_bytes_per_device_live"] >= got["state_bytes_per_device"]


@pytest.mark.parametrize("mesh,data", [("single", 16), ("multi", 32)])
def test_decode_cell_gathers_no_kv_cache(fresh, mesh, data):
    """deepseek-coder-33b at decode_32k (62 attention layers, 8 KV heads of
    128, bf16): each rank holds its 128 / ``data`` rows and 1/16 of the
    32768 positions ("model"), and a decode step attends over those slots
    alone (the ranks' softmax statistics are merged), so it gathers
    nothing: the bytes held while attending are the bytes held."""
    cell = f"{mesh}/deepseek-coder-33b__decode_32k.json"
    held = 62 * 2 * (128 // data) * (32768 // 16) * 8 * 128 * 2
    for got in (json.loads((fresh / cell).read_text()),
                json.loads((TWIN / cell).read_text())):
        assert got["decode_kv_bytes_per_device"] == held
        assert got["decode_kv_bytes_per_device_gathered"] == held


@pytest.mark.parametrize("arch,layout", list(TRACES),
                         ids=[f"{a}-{lay or 'default'}" for a, lay in TRACES])
def test_traced_smoke_cell_shows_its_layouts_collectives(runs, arch, layout):
    out, procs = runs
    for p in procs[layout or ""]:
        _wait(p)
    from repro_torch.parallel.cost import COLLECTIVES

    expect, absent = TRACES[(arch, layout)]
    cell = json.loads((out / (layout or "default") / "single"
                       / f"{arch}__train_4k.json").read_text())
    assert cell["n_devices"] == 8 and cell["flops_per_device"] > 0
    assert cell["bytes_per_device"] > cell["bytes_min_per_device"] > 0
    assert cell["top_dots"] and all(d["flops"] > 0 for d in cell["top_dots"])
    counts, coll = cell["collective_counts"], cell["collectives"]
    assert counts.get(expect, 0) > 0, counts
    if absent:
        assert absent not in counts, counts
    kinds = {COLLECTIVES[name] for name in counts}
    assert all(coll[kind] > 0 for kind in kinds), coll
    assert coll["total"] == coll["total_native"] == sum(coll[kind] for kind in kinds)
    assert coll["top_ops"] and {t["op"] for t in coll["top_ops"]} <= kinds
