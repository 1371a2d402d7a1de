"""On the card: one short run of a cell through the benchmark's command,
its last line held to the result's keys."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_one_short_run_prints_the_result_line(card, trace):
    out = subprocess.run([sys.executable, "mil_bench/run.py", "--workload",
                          "decon.sv512.gauss", "--seed", str(2 ** 31 + 99), "--seconds", "2",
                          "--trace", str(trace)], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] and res["failed"] == 0
    dev = res["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1 and dev["memory_peak_bytes"] > 0
    want = ({"decon_outside_loop_ms.decon", "rl_roofline.decon", "device_idle_pct.decon"}
            if trace else {"setup_s", "rl_gvoxit_per_s"})
    assert set(res["metrics"]) == want
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert 0 < res["metrics"]["rl_roofline.decon"]["value"] <= 100
