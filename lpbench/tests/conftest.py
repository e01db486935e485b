"""Shared fixtures of the benchmark's own tests (CPU; the card-only ones
are marked ``cuda`` and skip without a card)."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def few_torch_threads():
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def toy_predict_cell():
    """``ctx2v.predict_video`` with its committed limits, cut to a toy size
    for the CPU: 64 x 64 inputs from 48 x 64 frames, an 18-frame session in
    three 10-frame batches (6 windows each), a 12-frame warm-up clip."""
    from lpbench import harness

    cell = harness.load_cell("ctx2v.predict_video")
    config = copy.deepcopy(cell.config)
    config["config"]["data"]["image_resize_dims"] = {"height": 64, "width": 64}
    config["config"]["dali"]["context"]["predict"]["sequence_length"] = 10
    config["assumed"]["raw_frame"] = {"height": 48, "width": 64}
    mix = dict(cell.mix, session_frames=18, warm_up_frames=12)
    return harness.Cell(name="toy", chips=1, config=config, mix=mix, limits=cell.limits,
                        end_to_end=cell.end_to_end, per_layer=cell.per_layer)


@pytest.fixture
def cuda_card():
    """Skips the test unless a CUDA card is present (decided here, never
    at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
