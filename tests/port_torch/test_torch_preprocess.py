"""The port's normalize (ops/normalize_kernel.py, ops/preprocess.py) against
the JAX package's normalize_images and its Pallas kernel."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_pose_tpu.ops.pallas_preprocess import normalize_images_pallas
from lightning_pose_tpu.ops.preprocess import normalize_images as jax_normalize_images
from lightning_pose_tpu_torch.ops import normalize_kernel
from lightning_pose_tpu_torch.ops.preprocess import normalize_images, normalize_images_fused


def _frames(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    ia = a.contiguous().view(torch.int16).to(torch.int32)
    ib = b.contiguous().view(torch.int16).to(torch.int32)
    assert not bool(((ia < 0) != (ib < 0)).any())
    return int((ia - ib).abs().max())


def test_normalize_images_matches_jax():
    # same formula in fp32: equal to float32 rounding
    x = _frames((2, 5, 7, 3))
    ref = np.asarray(jax_normalize_images(jnp.asarray(x)))
    out = normalize_images(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_plain_normalize_matches_jax_fused_path(out_dtype):
    """The plain version is the reference's normalize_images + cast,
    returned as (B, 3, H, W) channels-last."""
    x = _frames((3, 6, 10, 3), seed=1)
    jax_dtype = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(jax_normalize_images(jnp.asarray(x)).astype(jax_dtype).astype(jnp.float32))
    out = normalize_kernel.normalize_plain(torch.from_numpy(x), out_dtype)
    assert out.shape == (3, 3, 6, 10) and out.dtype == out_dtype
    assert out.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(out.float().permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-6)


def test_plain_normalize_within_one_bf16_ulp_of_pallas_kernel():
    """The Pallas kernel is one FMA (x * scale + bias), the plain version
    (x/255 - mean)/std: at most 1 bf16 ulp apart."""
    x = _frames((2, 8, 128, 3), seed=2)  # the Pallas gate needs W*3 % 128 == 0
    ref = np.asarray(normalize_images_pallas(jnp.asarray(x), interpret=True).astype(jnp.float32))
    out = normalize_kernel.normalize_plain(torch.from_numpy(x), torch.bfloat16)
    ref_bf16 = torch.from_numpy(np.array(ref)).to(torch.bfloat16)
    assert _bf16_ulps(out.permute(0, 2, 3, 1), ref_bf16) <= 1


def test_wrapper_on_cpu_runs_plain_version_and_counts_no_launch():
    x = torch.from_numpy(_frames((2, 4, 5, 3), seed=3))
    before = normalize_kernel.launches
    out = normalize_images_fused(x, out_dtype=torch.bfloat16)
    assert normalize_kernel.launches == before
    torch.testing.assert_close(out, normalize_kernel.normalize_plain(x, torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize(
    "images, error",
    [
        (torch.zeros((2, 4, 4, 3), dtype=torch.float32), TypeError),
        (torch.zeros((4, 4, 3), dtype=torch.uint8), ValueError),
        (torch.zeros((2, 4, 4, 4), dtype=torch.uint8), ValueError),
    ],
)
def test_wrapper_rejects_bad_input(images, error):
    with pytest.raises(error):
        normalize_kernel.normalize(images, torch.bfloat16)


def test_wrapper_rejects_other_out_dtypes():
    with pytest.raises(TypeError):
        normalize_kernel.normalize(torch.zeros((1, 2, 2, 3), dtype=torch.uint8), torch.float16)
