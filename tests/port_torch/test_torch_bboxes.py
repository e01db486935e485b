"""The port's bbox transforms (data/bboxes.py) against the JAX package's."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_pose_tpu.data import bboxes as jax_bboxes
from lightning_pose_tpu_torch.data import bboxes


def _bbox(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 50, (n, 2))
    hw = rng.uniform(20, 120, (n, 2))
    return np.concatenate([xy, hw], axis=1).astype(np.float32)


def test_model_to_norm_and_norm_to_frame_match_jax():
    rng = np.random.default_rng(0)
    kp = rng.uniform(0, 64, (3, 5, 2)).astype(np.float32)
    box = _bbox(3, seed=1)
    norm_ref = np.asarray(jax_bboxes.model_to_norm(jnp.asarray(kp), 64, 48))
    norm = bboxes.model_to_norm(torch.from_numpy(kp), 64, 48)
    np.testing.assert_allclose(norm.numpy(), norm_ref, rtol=1e-6)
    frame_ref = np.asarray(jax_bboxes.norm_to_frame(jnp.asarray(norm_ref), jnp.asarray(box)))
    frame = bboxes.norm_to_frame(norm, torch.from_numpy(box))
    np.testing.assert_allclose(frame.numpy(), frame_ref, rtol=1e-6)


@pytest.mark.parametrize("n_kp_rows, n_bbox_rows", [(4, 4), (4, 8)])  # plain, context trim
def test_model_to_frame_batch_matches_jax(n_kp_rows, n_bbox_rows):
    rng = np.random.default_rng(n_kp_rows + n_bbox_rows)
    kp = rng.uniform(0, 64, (n_kp_rows, 2 * 3)).astype(np.float32)
    box = _bbox(n_bbox_rows, seed=2)
    ref = np.asarray(jax_bboxes.model_to_frame_batch(jnp.asarray(kp), jnp.asarray(box), 64, 48))
    out = bboxes.model_to_frame_batch(torch.from_numpy(kp), torch.from_numpy(box), 64, 48)
    assert out.shape == ref.shape == kp.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)
