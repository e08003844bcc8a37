"""On a card: the cell at its own size comes out correct, and its
control (the configuration's lower precision) does not. Skips without a
card."""

import json
import subprocess
import sys

import pytest

from benchmark.tests.helpers import REPO

pytestmark = pytest.mark.gpu


def _run(*extra):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "gpt2-small.zero2-ring", "--seconds", "3", "--trace", "0",
         *extra], cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("seed", [4_000_000_001, 4_000_000_003,
                                  4_000_000_007])
def test_control_at_the_cells_size_is_not_correct(card, seed):
    assert _run("--seed", str(seed), "--control")["correct"] is False


def test_sound_run_at_the_cells_size_is_correct(card):
    assert _run("--seed", "4000000009")["correct"] is True
