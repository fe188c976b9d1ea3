"""One short cell through the benchmark's command, on the card: it prints a
correct result line.  Skips where there is no CUDA card."""
import json
import subprocess
import sys

import pytest

import portbench_small as small


@pytest.mark.cuda
def test_short_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "road64k-batch-uniform", "--seed", "2147483653", "--seconds", "2",
         "--trace", "0"], cwd=small.BENCH.parent, capture_output=True,
        text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["metrics"]["queries_per_s"]["value"] > 0
    assert list(res)[-1] == "checks"


def test_without_a_card_the_command_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("runs where there is no CUDA card")
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "road64k-batch-uniform", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=small.BENCH.parent, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
