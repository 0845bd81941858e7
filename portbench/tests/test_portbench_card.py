"""Whole runs on the card at test sizes: the harness's own look for a card,
kernels launched, device readings present and the outputs correct. They
skip where there is no card."""

from __future__ import annotations

import pytest
import torch

from portbench.tests.conftest import BENCH, run_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_cell_on_the_card(card, tiny_root, cell, trace):
    rc, line = run_cell(tiny_root, cell, seed=(1 << 31) + 5, seconds=1.0,
                        trace=trace, device=None)
    assert rc == 0 and line["correct"] is True, line
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"]
    else:
        assert line["metrics"]["peak_device_GB"]["value"] > 0
