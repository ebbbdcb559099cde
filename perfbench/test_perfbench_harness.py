"""The traffic generator, the metric arithmetic, the result line, the
command's refusal without a card, and the reference against the program's
plain CPU path on tiny configurations."""

import json
import os
import pathlib
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest

from perfbench import harness
from perfbench import traffic as TR
from perfbench.conftest import CLOSED, DENSE, MOE, OPEN

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_same_seed_same_traffic():
    t = TR.load("repo-burst")
    a, b = TR.plan(t, 2**33 + 7, 40), TR.plan(t, 2**33 + 7, 40)
    assert [(r.due, r.prompt_len, r.max_new) for r in a] == \
        [(r.due, r.prompt_len, r.max_new) for r in b]
    pa, pb = TR.prompts(a, 49152, 2**33 + 7), TR.prompts(b, 49152, 2**33 + 7)
    assert all((x == y).all() for x, y in zip(pa, pb))
    c = TR.plan(t, 5, 40)
    # another seed: the same arrivals and lengths in the same order, other
    # token ids; each phase holds its count's quantiles of each length
    # distribution once
    assert [(r.due, r.prompt_len, r.max_new) for r in c] == \
        [(r.due, r.prompt_len, r.max_new) for r in a]
    pc = TR.prompts(c, 49152, 5)
    assert all(len(x) == len(y) and (x != y).any() for x, y in zip(pa, pc))
    for k in range(4):
        for p0, p1 in ((0, 8), (8, 10)):
            phase = [(r.prompt_len, r.max_new) for r in a
                     if 10 * k + p0 <= r.due < 10 * k + p1]
            n = len(phase)
            assert n == round(t["rate_rps"] * (0.75 if p0 == 0 else 2.0) * (p1 - p0))
            assert Counter(x for x, _ in phase) == Counter(
                TR.quantiles(*t["prompt_tokens"], t["prompt_dist"], n).tolist())
            assert Counter(y for _, y in phase) == Counter(
                TR.quantiles(*t["output_tokens"], t["output_dist"], n).tolist())
    # a phase's order is one draw, not the quantiles in sorted order
    assert [r.prompt_len for r in a] != sorted(r.prompt_len for r in a)
    lo, hi = t["prompt_tokens"]
    assert all(lo <= r.prompt_len <= hi and 8 <= r.max_new <= 24 for r in a)


def test_burst_cycle_counts():
    t = dict(TR.load("repo-burst"), rate_rps=5.0)
    reqs = TR.plan(t, 1, 40)
    due = [r.due for r in reqs]
    assert due == sorted(due) and min(due) >= -t["lead_in_s"] and max(due) < 40
    for k in range(4):  # 6 a second for 8 s, then 20 a second for 2 s
        assert sum(10 * k <= d < 10 * k + 8 for d in due) == 30
        assert sum(10 * k + 8 <= d < 10 * k + 10 for d in due) == 20
    assert sum(d < 0 for d in due) == round(3 * 3.75) + 2 * 10  # lead-in: 3 s base, a burst


def test_steady_poisson_of_the_sweep():
    """The sweep's steady load: Poisson arrivals drawn from the seed, at
    the rate asked for on average, over the lead-in and the window."""
    t = dict(TR.load("doc-burst"), loop="poisson", rate_rps=8.0)
    a, b, c = TR.plan(t, 11, 200), TR.plan(t, 11, 200), TR.plan(t, 12, 200)
    assert [r.due for r in a] == [r.due for r in b] != [r.due for r in c]
    due = np.array([r.due for r in a])
    assert (np.diff(due) > 0).all() and due[0] >= -t["lead_in_s"] and due[-1] < 200
    assert abs(len(due) / (200 + t["lead_in_s"]) - 8.0) < 0.6
    gaps = np.diff(due)
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.1  # exponential gaps
    lo, hi = t["prompt_tokens"]
    assert all(lo <= r.prompt_len <= hi for r in a)


def test_closed_loop_plan():
    t = TR.load("chat-closed")
    reqs = TR.plan(t, 3, 40)
    assert len(reqs) == t["requests"] and {r.client for r in reqs} == set(range(32))
    other = TR.plan(t, 4, 40)  # another seed: the same schedule
    assert [(r.prompt_len, r.max_new, r.client) for r in other] == \
        [(r.prompt_len, r.max_new, r.client) for r in reqs]
    for i in range(0, 256, 64):  # each block of 64: its quantiles once each
        assert Counter(r.max_new for r in reqs[i:i + 64]) == Counter(
            TR.quantiles(*t["output_tokens"], t["output_dist"], 64).tolist())
        assert Counter(r.prompt_len for r in reqs[i:i + 64]) == Counter(
            TR.quantiles(*t["prompt_tokens"], t["prompt_dist"], 64).tolist())
    starts = [TR.closed_start(t, c) for c in range(32)]
    assert starts[0] == -t["lead_in_s"] and all(s < 0 for s in starts)
    assert TR.bucket_for(128, t) == 128 and TR.bucket_for(129, t) == 256
    assert TR.bucket_for(4096, TR.load("doc-burst")) == 4096
    assert TR.bucket_for(7936, TR.load("repo-burst")) == 8192


class _Fake:
    """A finished run with hand-set token times: seconds 10."""

    def __init__(self):
        self.seconds = 10.0
        mk = lambda due, times: harness.Served(plan=TR.Planned(0, 4, len(times) or 3),
                                                due=due, times=times)
        self.served = [
            mk(-1.0, [0.5, 1.0]),  # lead-in: its tokens count, its first token does not
            mk(1.0, [1.5, 1.6, 2.6]),
            mk(2.0, [4.0, 4.1]),
            mk(9.0, []),  # no first token by the close: waited 1 s so far
            mk(9.5, [10.5]),  # its first token after the close: 0.5 s so far
        ]

    counted = harness.Run.counted
    end_to_end = harness.Run.end_to_end


def test_metric_arithmetic():
    f = _Fake()
    e = f.end_to_end()
    ttft = sorted([0.5, 2.0, 1.0, 0.5])  # over every request due in the window
    rank = 3 * 0.95
    p95 = ttft[2] + (ttft[3] - ttft[2]) * (rank - 2)
    assert e["ttft_p95_ms"] == pytest.approx(1e3 * p95)
    gaps = sorted([0.5, 0.1, 1.0, 0.1])  # every gap ending in the window
    assert e["itl_p95_ms"] == pytest.approx(1e3 * (gaps[2] + (gaps[3] - gaps[2]) * 0.85))
    assert e["tokens_per_s"] == 7 / 10  # every token of the window, over all of it


def test_result_line_and_reference_dense(tiny):
    result, run = tiny(DENSE, OPEN)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["metrics"]) == {"ttft_p95_ms", "itl_p95_ms", "tokens_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert result["attempted"] == len(run.counted()) > 0 and result["failed"] == 0
    # the reference agrees with the program's plain path on every served token
    assert result["correct"] and result["checks"]["logit_gap"]["value"] < 0.02
    assert list(result["checks"]) == ["logit_gap", "short_requests"]
    json.dumps(result)


def test_traced_moe_closed(tiny):
    result, run = tiny(MOE, CLOSED, trace=True)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    # the device's metrics are left out on the CPU; the batcher's, and the
    # program's spans, are read
    assert set(result["metrics"]) == {"queue_wait_ms", "slot_occupancy", "admit_wait_ms",
                                      "first_token_hold_ms", "decode_issue_ms"}
    assert 0 < result["metrics"]["slot_occupancy"]["value"] <= 100
    assert result["correct"], result["checks"]
    assert result["checks"]["keep_mismatch"]["value"] == 0
    assert run.timed.decodes and run.timed.prefills


def test_control_fails_where_program_passes(tiny):
    """The control, the reference with float8 products in the program's
    place, reads far above the program on the same tokens."""
    for config in (DENSE, MOE):
        result, run = tiny(config, dict(OPEN, check_tokens=200), seconds=1.5)
        program = harness.judge(run)
        control = harness.judge(run, quant="fp8")
        assert control["logit_gap"] > max(3 * program["logit_gap"], 0.05)
        assert not harness.verdict(control, {"logit_gap": 0.05})[0]


def test_command_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
         "starcoder2-3b.repo-burst", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_benchmark_json_contract():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert list(spec) == ["command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"]
    names = {m["name"] for m in spec["end_to_end"]}
    assert names == {"ttft_p95_ms", "itl_p95_ms", "tokens_per_s", "setup_s"}
    for c in spec["configs"]:
        assert (ROOT / c["file"]).exists()
        ref = json.loads((ROOT / c["file"]).read_text())["reference"]
        assert (ROOT / ref).is_file() and (ROOT / ref).parent == ROOT / "perfbench" / "reference"
    for w in spec["workloads"]:
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").exists()
    for m in spec["per_layer"]:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in names and m["layer"]
