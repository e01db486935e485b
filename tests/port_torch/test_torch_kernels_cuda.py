"""The port's hand-written kernels against their plain PyTorch versions on
a CUDA card. Every test here needs the card and skips without one.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed. There, run it without the repository's top-level
conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/port_torch/test_torch_kernels_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lightning_pose_tpu_torch.api.model import PredictStep
from lightning_pose_tpu_torch.models.factory import build_model
from lightning_pose_tpu_torch.ops import decode_kernel, normalize_kernel

pytestmark = pytest.mark.cuda

# keypoints within 0.05 px and confidences within 1e-3 of the plain
# version; both sum in fp32 in another order. A keypoint within rounding of
# a pixel edge may floor to the other side in one of them, which moves its
# confidence window by a pixel: those maps are counted, not compared.
KP_TOL_PX = 0.05
CONF_TOL = 1e-3
MAX_WINDOW_FLIPS = 2


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _frames(shape, seed=0) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8))


def _peaked_maps(b, k, h, w, seed=0) -> torch.Tensor:
    """Normalized Gaussian maps (sigma 1.25) at random points, (B, K, h, w)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, w, (b, k, 1, 1))
    y = rng.uniform(0, h, (b, k, 1, 1))
    yy = np.arange(h)[None, None, :, None]
    xx = np.arange(w)[None, None, None, :]
    maps = np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * 1.25**2))
    return torch.from_numpy((maps / maps.sum(axis=(2, 3), keepdims=True)).astype(np.float32))


def _assert_decode_close(kp, conf, kp_ref, conf_ref, df):
    torch.testing.assert_close(kp, kp_ref, rtol=0, atol=KP_TOL_PX)
    offset = decode_kernel.GRID_OFFSETS[df]
    same = (torch.floor(kp + offset) == torch.floor(kp_ref + offset)).reshape(conf.shape + (2,))
    same = same.all(dim=-1)
    assert int((~same).sum()) <= MAX_WINDOW_FLIPS
    torch.testing.assert_close(conf[same], conf_ref[same], rtol=0, atol=CONF_TOL)


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    ia = a.contiguous().view(torch.int16).to(torch.int32)
    ib = b.contiguous().view(torch.int16).to(torch.int32)
    assert not bool(((ia < 0) != (ib < 0)).any())
    return int((ia - ib).abs().max())


@pytest.mark.parametrize("shape", [(96, 256, 256, 3), (3, 17, 31, 3)])
def test_normalize_kernel_matches_plain(cuda_device, shape):
    """<= 1 bf16 ulp (one FMA against (x/255 - mean)/std); the ragged shape
    exercises the mask of the last block."""
    x = _frames(shape, seed=1).to(cuda_device)
    before = normalize_kernel.launches
    out = normalize_kernel.normalize(x, torch.bfloat16)
    ref = normalize_kernel.normalize_plain(x, torch.bfloat16)
    torch.cuda.synchronize()
    assert normalize_kernel.launches == before + 1
    assert out.shape == (shape[0], 3, shape[1], shape[2])
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert _bf16_ulps(out, ref) <= 1
    out32 = normalize_kernel.normalize(x, torch.float32)
    torch.testing.assert_close(out32, normalize_kernel.normalize_plain(x, torch.float32), rtol=0, atol=1e-5)


@pytest.mark.parametrize(
    "b, k, h, w, df",
    [(96, 17, 64, 64, 2), (4, 17, 48, 64, 2), (3, 5, 16, 16, 1), (2, 3, 16, 12, 3), (2, 3, 20, 20, 0)],
)
def test_decode_kernel_matches_plain(cuda_device, b, k, h, w, df):
    hm = _peaked_maps(b, k, h, w, seed=b + h).to(cuda_device)
    before = decode_kernel.launches
    kp, conf = decode_kernel.decode(hm, df)
    kp_ref, conf_ref = decode_kernel.decode_plain(hm, df)
    torch.cuda.synchronize()
    assert decode_kernel.launches == before + 1
    _assert_decode_close(kp, conf, kp_ref, conf_ref, df)


def test_decode_kernel_matches_plain_on_flat_maps(cuda_device):
    """Softmaxed random logits: mass spread over the map."""
    rng = np.random.default_rng(2)
    z = torch.from_numpy(rng.standard_normal((8, 17, 64 * 64)).astype(np.float32) * 3.0)
    hm = torch.softmax(z, dim=-1).reshape(8, 17, 64, 64).to(cuda_device)
    kp, conf = decode_kernel.decode(hm, 2)
    kp_ref, conf_ref = decode_kernel.decode_plain(hm, 2)
    _assert_decode_close(kp, conf, kp_ref, conf_ref, 2)


def test_kernels_reject_what_they_do_not_take(cuda_device):
    with pytest.raises(TypeError):
        decode_kernel.decode(_peaked_maps(1, 2, 16, 16).to(cuda_device).half(), 2)
    with pytest.raises(ValueError):
        decode_kernel.decode(_peaked_maps(1, 2, 16, 16).to(cuda_device).transpose(2, 3), 2)
    with pytest.raises(ValueError):
        normalize_kernel.normalize(_frames((2, 8, 8, 3)).to(cuda_device).transpose(1, 2), torch.bfloat16)


def test_predict_step_on_card_matches_cpu(cuda_device):
    """fp32 resnet18 predict step: kernels on the card vs plain versions on
    the CPU, same weights."""
    torch.manual_seed(0)
    model = build_model("heatmap", "resnet18", 4).eval()
    with torch.no_grad():
        for name in ("deconv0", "deconv1"):
            getattr(model.head, name).weight.mul_(300.0)
    frames = _frames((2, 64, 64, 3), seed=3)
    bbox = torch.tensor([[0.0, 0.0, 60.0, 80.0]] * 2)
    kp_cpu, conf_cpu = PredictStep(model, 64, 64, torch.float32)(frames, bbox)
    gpu_model = model.to(cuda_device, memory_format=torch.channels_last)
    kp, conf = PredictStep(gpu_model, 64, 64, torch.float32)(frames.to(cuda_device), bbox.to(cuda_device))
    torch.testing.assert_close(kp.cpu(), kp_cpu, rtol=0, atol=KP_TOL_PX)
    torch.testing.assert_close(conf.cpu(), conf_cpu, rtol=0, atol=CONF_TOL)


def test_banded_sums_equal_dense_ones(cuda_device):
    """The kernel sums over the non-zero band of the upsample matrices; with
    every row's band widened to the whole row the outputs are bitwise the
    same, since the skipped terms are exact zeros."""
    hm = _peaked_maps(8, 17, 64, 64, seed=5).to(cuda_device)
    kp, conf = decode_kernel.decode(hm, 2)
    operands = decode_kernel._device_operands(64, 64, 2, 4, cuda_device)
    banded = [band.clone() for band in operands[2:]]
    try:
        for band in operands[2:]:
            band[:, 0], band[:, 1] = 0, 64
        kp_dense, conf_dense = decode_kernel.decode(hm, 2)
    finally:
        for band, saved in zip(operands[2:], banded):
            band.copy_(saved)
    assert torch.equal(kp, kp_dense) and torch.equal(conf, conf_dense)
