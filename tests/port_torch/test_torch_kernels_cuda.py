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
from lightning_pose_tpu_torch.ops import clahe_kernel, decode_kernel, normalize_kernel, warp_kernel
from lightning_pose_tpu_torch.ops.augment import AugmentationEngine, _clahe_lut_grid

pytestmark = pytest.mark.cuda

# keypoints within 0.05 px and confidences within 1e-3 of the plain
# version; both sum in fp32 in another order. A keypoint within rounding of
# a pixel edge may floor to the other side in one of them, which moves its
# confidence window by a pixel: those maps are counted, not compared.
KP_TOL_PX = 0.05
CONF_TOL = 1e-3
MAX_WINDOW_FLIPS = 2
# warp and CLAHE kernels against their plain versions, fp32 against fp32:
# the same terms summed in another order, on 0-255 gray levels
GRAY_TOL = 1e-3
# the decode's backward kernel against autograd of the plain decode, both
# fp32 (TF32 off): the largest gradient error within 1e-3 of the largest
# gradient entry. The temperature of 1000 multiplies the rounding of the
# upsampled maps by 1000 * log2(e) in the recomputed softmax.
GRAD_REL_TOL = 1e-3


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
    [
        (96, 17, 64, 64, 2),  # the product shape
        (4, 17, 48, 64, 2),  # rectangular
        (3, 5, 16, 16, 1),
        (2, 3, 16, 12, 3),
        (2, 3, 20, 20, 0),  # the strips own 12 and 8 rows
        (1, 1, 64, 64, 2),  # a single map
        (1, 3, 5, 7, 1),  # the second strip owns 2 rows of a 4-row tile; W not a multiple of 4
        (2, 3, 4, 4, 0),  # one row tile: the second block of each cluster owns no rows
        (1, 2, 2, 3, 1),  # the same, upsampled, with W not a multiple of 4
    ],
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


def _decode_grads(hm, df, seed=0):
    """The heatmaps' gradient of ``sum(g * keypoints)`` for seeded ``g``,
    through the kernels and through autograd of the plain decode; and the
    kernels' keypoints."""
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal((hm.shape[0], 2 * hm.shape[1])).astype(np.float32))
    g = g.to(hm.device)
    x = hm.clone().requires_grad_()
    kp, conf = decode_kernel.decode(x, df)
    (kp * g).sum().backward()
    x_ref = hm.clone().requires_grad_()
    kp_ref, _ = decode_kernel.decode_plain(x_ref, df)
    (kp_ref * g).sum().backward()
    torch.cuda.synchronize()
    return x.grad, x_ref.grad, kp, conf


@pytest.mark.parametrize(
    "b, k, h, w, df",
    [
        (32, 17, 64, 64, 2),  # the unlabeled window's maps at the product shape
        (4, 17, 48, 64, 2),  # rectangular
        (2, 5, 32, 32, 3),
        (3, 3, 20, 12, 1),  # H not a multiple of the 16-row chunk; W of 8
        (2, 3, 9, 7, 0),
        (3, 7, 64, 64, 2),  # 21 maps: no multiple of the cluster or the strip count
        (2, 5, 64, 64, 3),  # strips of 128 rows walked in chunks
        (1, 2, 128, 128, 2),  # too many dhm tiles a strip to cut their rows in two
    ],
)
def test_decode_backward_kernel_matches_autograd_of_plain(cuda_device, b, k, h, w, df):
    hm = _peaked_maps(b, k, h, w, seed=b + w).to(cuda_device)
    before = (decode_kernel.launches, decode_kernel.grad_launches)
    grad, grad_ref, _, _ = _decode_grads(hm, df, seed=h)
    assert (decode_kernel.launches, decode_kernel.grad_launches) == (before[0] + 1, before[1] + 1)
    scale = float(grad_ref.abs().max())
    assert scale > 0 and bool(torch.isfinite(grad).all())
    assert float((grad - grad_ref).abs().max()) <= GRAD_REL_TOL * scale


def test_decode_backward_kernel_is_deterministic(cuda_device):
    """No atomics: two launches on the same inputs give bitwise the same
    gradient."""
    hm = _peaked_maps(32, 17, 64, 64, seed=8).to(cuda_device)
    ops = decode_kernel._device_operands(64, 64, 2, decode_kernel._layout(), cuda_device)
    lse2 = torch.empty(32 * 17, device=cuda_device)
    kp, _ = decode_kernel._launch(hm, ops, 2, 1000.0, lse2)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal((32, 34)).astype(np.float32)).to(cuda_device)
    first = decode_kernel._launch_grad(hm, kp, lse2, g, ops, 2, 1000.0)
    second = decode_kernel._launch_grad(hm, kp, lse2, g, ops, 2, 1000.0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(first).all()) and torch.equal(first, second)


def test_decode_backward_on_flat_maps(cuda_device):
    """Softmaxed random logits: the mass, and so the gradient, spread out."""
    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.standard_normal((4, 17, 64 * 64)).astype(np.float32) * 3.0)
    hm = torch.softmax(z, dim=-1).reshape(4, 17, 64, 64).to(cuda_device)
    grad, grad_ref, _, _ = _decode_grads(hm, 2, seed=4)
    assert float((grad - grad_ref).abs().max()) <= GRAD_REL_TOL * float(grad_ref.abs().max())


def test_decode_lse2_leaves_the_forward_bitwise(cuda_device):
    """The forward with its log-sum-exp output on writes bitwise the
    keypoints and confidences it writes with it off; the log-sum-exp is the
    plain one's within fp32 rounding of logits of about 1000 * log2(e)."""
    hm = _peaked_maps(96, 17, 64, 64, seed=6).to(cuda_device)
    ops = decode_kernel._device_operands(64, 64, 2, decode_kernel._layout(), cuda_device)
    lse2 = torch.full((96 * 17,), float("nan"), device=cuda_device)
    kp, conf = decode_kernel._launch(hm, ops, 2, 1000.0)
    kp_l, conf_l = decode_kernel._launch(hm, ops, 2, 1000.0, lse2)
    torch.cuda.synchronize()
    assert torch.equal(kp, kp_l) and torch.equal(conf, conf_l)
    m_h = torch.from_numpy(np.array(decode_kernel.upsample_matrix(64, 2))).to(cuda_device)
    up = (m_h @ hm @ m_h.T).reshape(96 * 17, -1).double()
    ref = torch.logsumexp(up * 1000.0, dim=-1) / np.log(2.0)
    torch.testing.assert_close(lse2.double(), ref, rtol=0, atol=1e-3)


def test_decode_with_grad_on_cuda_returns_keypoints_with_a_gradient(cuda_device):
    """A CUDA decode of maps that require grad goes through the autograd
    function: its keypoints carry a grad_fn, its confidences none; without
    grad mode it is the forward-only launch."""
    hm = _peaked_maps(2, 3, 16, 16).to(cuda_device).requires_grad_()
    kp, conf = decode_kernel.decode(hm, 2)
    assert kp.grad_fn is not None and kp.requires_grad
    assert not conf.requires_grad
    with torch.no_grad():
        kp_ng, _ = decode_kernel.decode(hm, 2)
    assert kp_ng.grad_fn is None
    torch.testing.assert_close(kp.detach(), kp_ng, rtol=0, atol=0)
    before = decode_kernel.grad_launches
    kp.sum().backward()
    assert decode_kernel.grad_launches == before + 1 and hm.grad is not None


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
    every Mh tile's band widened to its strip's staged rows and every Mw
    tile's band to the widest the kernel takes, the outputs are bitwise the
    same, since the skipped terms are exact zeros."""
    hm = _peaked_maps(8, 17, 64, 64, seed=5).to(cuda_device)
    kp, conf = decode_kernel.decode(hm, 2)
    layout = decode_kernel._layout()
    banded = decode_kernel._device_operands(64, 64, 2, layout, cuda_device)
    m_h, m_w = decode_kernel._padded_matrices(64, 64, 2, layout)
    strips = banded.strip_band.cpu().numpy()
    tiles_per_strip = banded.strip_rows // layout.band_rows
    mh_wide = np.repeat(strips, tiles_per_strip, axis=0)[: len(banded.mh_band)]
    mw = banded.mw_band.cpu().numpy()
    lo = np.clip(mw[:, 1] - layout.max_band, 0, 64 - layout.max_band)
    mw_wide = np.stack([lo, lo + layout.max_band], axis=1).astype(np.int32)
    assert (mh_wide[:, 1] - mh_wide[:, 0]).min() > (banded.mh_band[:, 1] - banded.mh_band[:, 0]).max().item()
    dense = decode_kernel._operands_from_bands(m_h, m_w, mh_wide, mw_wide, layout, cuda_device)
    kp_dense, conf_dense = decode_kernel._launch(hm, dense, 2, 1000.0)
    assert torch.equal(kp, kp_dense) and torch.equal(conf, conf_dense)


def _warp_inputs(b, h, w, seed=0):
    """0-255 images and rotated, jittered pixel coords: taps fall outside
    the frame too."""
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32))
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
    theta, cx, cy = 0.4, (w - 1) / 2.0, (h - 1) / 2.0
    px = np.cos(theta) * (xs - cx) - np.sin(theta) * (ys - cy) + cx
    py = np.sin(theta) * (xs - cx) + np.cos(theta) * (ys - cy) + cy
    coords = np.stack([np.stack([px, py], -1)] * b) + rng.uniform(-8, 8, (b, h, w, 2))
    return img, torch.from_numpy(coords.astype(np.float32))


@pytest.mark.parametrize("shape", [(16, 256, 256), (3, 200, 136), (1, 7, 5), (2, 33, 37), (2, 9, 6)])
def test_warp_kernel_matches_plain(cuda_device, shape):
    img, coords = (t.to(cuda_device) for t in _warp_inputs(*shape, seed=shape[1]))
    before = warp_kernel.launches
    out = warp_kernel.warp(img, coords)
    ref = warp_kernel.warp_plain(img, coords)
    torch.cuda.synchronize()
    assert warp_kernel.launches == before + 1
    assert bool((ref == 0).any())
    torch.testing.assert_close(out, ref, rtol=0, atol=GRAY_TOL)


def _clahe_inputs(n, h, w, g, device, seed=None):
    """Pixels a little outside 0-255 and the LUTs the port builds from them."""
    rng = np.random.default_rng(n + g if seed is None else seed)
    x = torch.from_numpy(rng.uniform(-3, 258, (n, h, w)).astype(np.float32)).to(device)
    images = x.clamp(0, 255).to(torch.int64).reshape(1, n, h, w)
    clip = torch.full((1,), 3.0, device=device)
    return x, _clahe_lut_grid(images, clip, g).reshape(n, g, g, 256).contiguous()


@pytest.mark.parametrize(
    "n, h, w, g",
    [
        (48, 256, 256, 16),  # the product shape
        (6, 256, 256, 16),  # a train step's fired subset
        (1, 256, 256, 16),
        (6, 256, 256, 8),
        (5, 96, 160, 8),  # half-block columns of 10: the scalar path
        (2, 60, 36, 3),  # half-block columns of 6, an odd grid
        (3, 64, 64, 2),  # tall half-blocks
    ],
)
def test_clahe_kernel_matches_plain(cuda_device, n, h, w, g):
    x, lut = _clahe_inputs(n, h, w, g, cuda_device)
    before = clahe_kernel.launches
    out = clahe_kernel.clahe_apply(x, lut, g)
    ref = clahe_kernel.clahe_apply_plain(x, lut, g)
    torch.cuda.synchronize()
    assert clahe_kernel.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=0, atol=GRAY_TOL)


@pytest.mark.parametrize("n, h, w, g", [(6, 256, 256, 16), (2, 128, 384, 8), (3, 64, 64, 2)])
def test_clahe_kernel_matches_plain_by_every_plan(cuda_device, n, h, w, g):
    """Every band count, column-tile width and pixel path the kernel takes
    (bands that start and end inside a group, bands of one half-block row)."""
    x, lut = _clahe_inputs(n, h, w, g, cuda_device)
    ref = clahe_kernel.clahe_apply_plain(x, lut, g)
    vecs = (1, 4) if (w // (2 * g)) % 4 == 0 else (1,)
    before = clahe_kernel.launches
    count = 0
    for vec in vecs:
        for threads_x in (64, 32, 16, 256):
            for bands in range(1, 2 * g + 1):
                plan = clahe_kernel.make_plan(n, h, w, g, vec, threads_x, bands)
                out = clahe_kernel._launch(x, lut, torch.full_like(x, float("nan")), plan)
                torch.testing.assert_close(out, ref, rtol=0, atol=GRAY_TOL, msg=lambda m: f"{plan}: {m}")
                count += 1
    assert clahe_kernel.launches == before + count


def test_clahe_plan_occupancy_matches_the_card(cuda_device):
    """The blocks an SM holds, as the plan counts them (launch bounds, shared
    memory, threads), are what the CUDA occupancy calculator says; the
    plan's shared memory is the kernel's."""
    for n, h, w, g in [(48, 256, 256, 16), (6, 256, 256, 8), (5, 96, 160, 8), (2, 128, 2048, 64)]:
        for vec_ok in (True, False):
            plan = clahe_kernel.blend_plan(n, h, w, g, vec_ok, 132)
            assert clahe_kernel.blocks_per_sm(plan, cuda_device) == plan.blocks_per_sm, plan
            assert clahe_kernel._library().lp_clahe_smem_bytes(plan.tile_cols) == plan.smem_bytes


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_clahe_kernel_on_offset_tensors(cuda_device, offset):
    """Pixels, LUTs and output that start ``offset`` floats into their
    buffers (not 16-byte aligned: scalar pixel accesses, 4-byte LUT
    copies) give what fresh tensors give; the 16-byte path refuses them."""
    n, h, w, g = 6, 256, 256, 16
    x, lut = _clahe_inputs(n, h, w, g, cuda_device, seed=offset)
    ref = clahe_kernel.clahe_apply_plain(x, lut, g)

    def shifted(t):
        buf = torch.zeros(t.numel() + offset, device=cuda_device)
        return buf[offset:].view(t.shape).copy_(t)

    x_u, lut_u, out_u = shifted(x), shifted(lut), shifted(torch.zeros_like(x))
    before = clahe_kernel.launches
    out = clahe_kernel.clahe_apply(x_u, lut_u, g)
    sm_count = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = clahe_kernel.blend_plan(n, h, w, g, False, sm_count)
    assert plan.vec == 1
    clahe_kernel._launch(x, lut_u, out_u, plan)
    torch.cuda.synchronize()
    assert clahe_kernel.launches == before + 2
    torch.testing.assert_close(out, ref, rtol=0, atol=GRAY_TOL)
    torch.testing.assert_close(out_u, ref, rtol=0, atol=GRAY_TOL)
    with pytest.raises(ValueError):
        clahe_kernel._launch(x, lut, out_u, clahe_kernel.blend_plan(n, h, w, g, True, sm_count))
    assert clahe_kernel.launches == before + 2


def test_warp_kernel_all_taps_outside(cuda_device):
    img, coords = (t.to(cuda_device) for t in _warp_inputs(2, 24, 20, seed=7))
    for shift in ((-50.0, 0.0), (0.0, 1e9), (30.0, -30.0), (-1.5, -1.5)):
        far = (coords * 0 + torch.tensor(shift, device=cuda_device)).contiguous()
        out = warp_kernel.warp(img, far)
        torch.cuda.synchronize()
        assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_warp_kernel_on_offset_tensors(cuda_device, offset):
    """Images that start ``offset`` floats into their buffer and coordinates
    ``2 * offset`` floats into theirs (still 8-byte aligned) give what fresh
    tensors give; coordinates that are not 8-byte aligned are refused."""
    img, coords = _warp_inputs(2, 20, 24, seed=9)
    img_buf = torch.zeros(img.numel() + offset, device=cuda_device)
    coords_buf = torch.zeros(coords.numel() + 2 * offset, device=cuda_device)
    img_u = img_buf[offset:].view(img.shape).copy_(img.to(cuda_device))
    coords_u = coords_buf[2 * offset:].view(coords.shape).copy_(coords.to(cuda_device))
    out = warp_kernel.warp(img_u, coords_u)
    ref = warp_kernel.warp_plain(img_u, coords_u)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=GRAY_TOL)
    with pytest.raises(ValueError):
        warp_kernel.warp(img_u, coords_buf[1 : 1 + coords.numel()].view(coords.shape))


def test_warp_kernel_on_the_clamped_grid(cuda_device):
    """The motion-blur path samples at coordinates clamped into the frame:
    taps on the last row and column, weights 0 for the tap beyond."""
    img, coords = (t.to(cuda_device) for t in _warp_inputs(3, 64, 52, seed=8))
    clamped = torch.stack([coords[..., 0].clamp(0, 51), coords[..., 1].clamp(0, 63)], dim=-1).contiguous()
    out = warp_kernel.warp(img, clamped)
    ref = warp_kernel.warp_plain(img, clamped)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=GRAY_TOL)


def test_warp_and_clahe_reject_what_they_do_not_take(cuda_device):
    img, coords = (t.to(cuda_device) for t in _warp_inputs(2, 16, 16))
    with pytest.raises(TypeError):
        warp_kernel.warp(img.double(), coords.double())
    with pytest.raises(ValueError):
        warp_kernel.warp(img.transpose(1, 2), coords.transpose(1, 2))
    with pytest.raises(ValueError):
        warp_kernel.warp(img, coords.cpu())
    with pytest.raises(ValueError):
        warp_kernel.warp(img[..., :2].contiguous(), coords)
    x = torch.zeros(3, 32, 32, device=cuda_device)
    lut = torch.zeros(3, 4, 4, 256, device=cuda_device)
    with pytest.raises(TypeError):
        clahe_kernel.clahe_apply(x.half(), lut.half(), 4)
    with pytest.raises(ValueError):
        clahe_kernel.clahe_apply(x.transpose(1, 2), lut, 4)
    with pytest.raises(ValueError):
        clahe_kernel.clahe_apply(x[:, :30], lut, 4)


def _forced_draws(engine, b):
    """dlc draws where histeq, CLAHE and emboss fire on some images."""
    draws = engine.sample(torch.Generator().manual_seed(11), b, torch.Generator(device="cuda").manual_seed(11))
    draws.histeq_u[0], draws.clahe_u[1], draws.emboss_u[2] = 0.0, 0.0, 0.0
    draws.clahe_u[3] = draws.emboss_u[3] = 0.0
    return draws


def test_engine_on_card_matches_cpu(cuda_device):
    """The engine with the kernels on the card against the same call with
    the plain versions on the CPU, same draws: keypoints within 1e-3 px;
    images within 0.01 gray but for the few pixels whose value lies within
    rounding of an integer and truncates into another histogram bin."""
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.integers(0, 256, (6, 256, 256, 3), dtype=np.uint8))
    keypoints = torch.from_numpy(rng.uniform(0, 256, (6, 17, 2)).astype(np.float32))
    engine = AugmentationEngine("dlc", 256, 256)
    draws = _forced_draws(engine, 6)
    before = (warp_kernel.launches, clahe_kernel.launches)
    out, kp = engine.apply(images.to(cuda_device), keypoints.to(cuda_device), None, draws)
    torch.cuda.synchronize()
    assert (warp_kernel.launches, clahe_kernel.launches) == (before[0] + 1, before[1] + 1)
    cpu_draws = type(draws)(**{k: (v.cpu() if v is not None else None) for k, v in vars(draws).items()})
    ref, ref_kp = engine.apply(images, keypoints, None, cpu_draws)
    assert torch.equal(torch.isnan(kp.cpu()), torch.isnan(ref_kp))
    finite = ~torch.isnan(ref_kp)
    torch.testing.assert_close(kp.cpu()[finite], ref_kp[finite], rtol=0, atol=1e-3)
    assert float(((out.cpu() - ref).abs() > 0.01).float().mean()) < 1e-3


def test_one_train_step_on_card_launches_the_kernels(cuda_device):
    """A resnet18 train step on the card (bf16 autocast): warp once, CLAHE
    once (forced to fire), a finite loss, and the parameters move."""
    from lightning_pose_tpu_torch.config import load_config
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    from lightning_pose_tpu_torch.train import trainer

    cfg = load_config()
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 128
    cfg.training.max_epochs = 2
    cfg.training.unfreezing_epoch = 0
    torch.manual_seed(0)
    model = build_model("heatmap", "resnet18", 5).to(cuda_device, memory_format=torch.channels_last)
    optimizer, head_sched, bb_sched = trainer.make_optimizer(cfg, 10, model)
    state = trainer.TrainState(model=model, optimizer=optimizer)
    engine = AugmentationEngine("dlc", 128, 128)
    step = trainer.make_step_fns({"model_type": "heatmap", "downsample_factor": 2}, get_loss_factories(cfg),
                                 engine, cfg, head_sched, bb_sched, 10)[2]
    rng = np.random.default_rng(5)
    cache = {
        "images": torch.from_numpy(rng.integers(0, 256, (8, 128, 128, 3), dtype=np.uint8)),
        "keypoints": torch.from_numpy(rng.uniform(0, 128, (8, 5, 2)).astype(np.float32)),
        "visibility": torch.full((8, 5), 2, dtype=torch.int64),
        "bbox": torch.tensor([[0.0, 0.0, 128.0, 128.0]] * 8),
    }
    cache = {k: v.to(cuda_device) for k, v in cache.items()}
    before = (warp_kernel.launches, clahe_kernel.launches)
    weight = model.head.deconv0.weight.detach().clone()
    logs = step(state, cache, torch.arange(4, device=cuda_device), torch.ones(4, dtype=torch.bool, device=cuda_device),
                _forced_draws(engine, 4))
    torch.cuda.synchronize()
    assert (warp_kernel.launches, clahe_kernel.launches) == (before[0] + 1, before[1] + 1)
    assert bool(torch.isfinite(logs["total_loss"])) and state.step == 1
    assert not torch.equal(weight, model.head.deconv0.weight)


def test_one_semisupervised_step_on_card_launches_the_kernels(cuda_device, tmp_path):
    """A resnet18 semi-supervised step on the card (bf16 autocast), 4
    labeled frames and an 8-frame window: the warp twice, the decode forward
    twice (labeled RMSE, unlabeled), its backward once; finite losses."""
    from lightning_pose_tpu_torch.config import load_config
    from lightning_pose_tpu_torch.losses.factory import LossFactory
    from lightning_pose_tpu_torch.losses.losses import TemporalLoss
    from lightning_pose_tpu_torch.ops.video_augment import sample_video_draws
    from lightning_pose_tpu_torch.train import trainer

    cfg = load_config()
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 128
    cfg.training.max_epochs = 2
    cfg.training.unfreezing_epoch = 0
    cfg.callbacks.anneal_weight.freeze_until_epoch = 0
    cfg.callbacks.anneal_weight.init_val = 1.0
    torch.manual_seed(0)
    model = build_model("heatmap", "resnet18", 5).to(cuda_device, memory_format=torch.channels_last)
    optimizer, head_sched, bb_sched = trainer.make_optimizer(cfg, 10, model)
    state = trainer.TrainState(model=model, optimizer=optimizer)
    engine = AugmentationEngine("dlc", 128, 128)
    factories = {
        "supervised": LossFactory({"heatmap_mse": {"log_weight": 0.0}}),
        "unsupervised": LossFactory({"temporal": {"log_weight": 0.0}}),
    }
    assert isinstance(factories["unsupervised"].loss_instance_dict["temporal"], TemporalLoss)
    step = trainer.make_step_fns({"model_type": "heatmap", "downsample_factor": 2}, factories,
                                 engine, cfg, head_sched, bb_sched, 10)[2]
    rng = np.random.default_rng(5)
    cache = {
        "images": torch.from_numpy(rng.integers(0, 256, (8, 128, 128, 3), dtype=np.uint8)),
        "keypoints": torch.from_numpy(rng.uniform(0, 128, (8, 5, 2)).astype(np.float32)),
        "visibility": torch.full((8, 5), 2, dtype=torch.int64),
        "bbox": torch.tensor([[0.0, 0.0, 128.0, 128.0]] * 8),
    }
    cache = {k: v.to(cuda_device) for k, v in cache.items()}
    window = {
        "frames": torch.from_numpy(rng.integers(0, 256, (8, 128, 128, 3), dtype=np.uint8)).to(cuda_device),
        "bbox": torch.tensor([[0.0, 0.0, 120.0, 160.0]] * 8, device=cuda_device),
    }
    gen, field_gen = torch.Generator().manual_seed(1), torch.Generator(cuda_device).manual_seed(1)
    draws = engine.sample(gen, 4, field_gen)
    video_draws = sample_video_draws(gen, 8, 128, 128, field_gen)
    before = (warp_kernel.launches, decode_kernel.launches, decode_kernel.grad_launches)
    logs = step(state, cache, torch.arange(4, device=cuda_device), torch.ones(4, dtype=torch.bool, device=cuda_device),
                draws, window, video_draws)
    torch.cuda.synchronize()
    after = (warp_kernel.launches, decode_kernel.launches, decode_kernel.grad_launches)
    assert tuple(a - b for a, b in zip(after, before)) == (2, 2, 1)
    assert bool(torch.isfinite(logs["total_loss"])) and bool(torch.isfinite(logs["train_unsupervised_loss"]))
    assert state.step == 1


# -- the context model's shapes --------------------------------------------------------


def _multiframe_maps(device, windows=28, k=17, size=256):
    """The multi-frame head's maps of a random-init context model (resnet18,
    the CRNN at flax's Xavier gain 1.0) on the sliding windows of a window
    of random frames, train mode, bf16: ``(windows, k, size/4, size/4)``."""
    from lightning_pose_tpu_torch.models.heatmap_tracker_mhcrnn import make_context_windows
    from lightning_pose_tpu_torch.ops.preprocess import normalize_images

    torch.manual_seed(0)
    model = build_model("heatmap_mhcrnn", "resnet18", k).to(device, memory_format=torch.channels_last).train()
    frames = _frames((windows + 4, size, size, 3), seed=7).to(device)
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        _, hm_mf = model(make_context_windows(normalize_images(frames).permute(0, 3, 1, 2)))
    return hm_mf.float().contiguous()


def test_warp_kernel_over_context_stacks_matches_plain(cuda_device):
    """16 stacks of 5 frames, each stack's sampling field repeated over its
    frames (what the engine gives the kernel for context stacks)."""
    engine = AugmentationEngine("dlc", 256, 256)
    draws = _forced_draws(engine, 16)
    _, coords, _, _ = engine.sampling_grid(draws, 16, cuda_device)
    coords = coords.repeat_interleave(5, dim=0).contiguous()
    images = _frames((80, 256, 256, 3), seed=8).to(cuda_device, torch.float32)
    before = warp_kernel.launches
    out = warp_kernel.warp(images, coords)
    ref = warp_kernel.warp_plain(images, coords)
    torch.cuda.synchronize()
    assert warp_kernel.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=0, atol=GRAY_TOL)


def test_engine_on_context_stacks_on_card_matches_cpu(cuda_device):
    """The engine on (4, 5, 256, 256, 3) stacks: one warp launch over the 20
    frames, one CLAHE launch over the fired stacks' frames; card against
    CPU, same draws."""
    rng = np.random.default_rng(9)
    stacks = torch.from_numpy(rng.integers(0, 256, (4, 5, 256, 256, 3), dtype=np.uint8))
    keypoints = torch.from_numpy(rng.uniform(0, 256, (4, 17, 2)).astype(np.float32))
    engine = AugmentationEngine("dlc", 256, 256)
    draws = _forced_draws(engine, 4)
    before = (warp_kernel.launches, clahe_kernel.launches)
    out, kp = engine.apply(stacks.to(cuda_device), keypoints.to(cuda_device), None, draws)
    torch.cuda.synchronize()
    assert (warp_kernel.launches, clahe_kernel.launches) == (before[0] + 1, before[1] + 1)
    cpu_draws = type(draws)(**{k: (v.cpu() if v is not None else None) for k, v in vars(draws).items()})
    ref, ref_kp = engine.apply(stacks, keypoints, None, cpu_draws)
    assert out.shape == (4, 5, 256, 256, 3)
    finite = ~torch.isnan(ref_kp)
    torch.testing.assert_close(kp.cpu()[finite], ref_kp[finite], rtol=0, atol=1e-3)
    assert float(((out.cpu() - ref).abs() > 0.01).float().mean()) < 1e-3


def test_decode_and_backward_on_multiframe_maps_match_plain(cuda_device):
    """The decode and its backward kernel on the CRNN head's maps at the
    semi-supervised window's shape (28, 17, 64, 64): probability maps from a
    gain-1.0 head, more peaked than the single-frame head's."""
    hm = _multiframe_maps(cuda_device)
    assert hm.shape == (28, 17, 64, 64)
    np.testing.assert_allclose(hm.sum(dim=(2, 3)).cpu().numpy(), 1.0, rtol=1e-4)
    kp, conf = decode_kernel.decode(hm, 2)
    kp_ref, conf_ref = decode_kernel.decode_plain(hm, 2)
    _assert_decode_close(kp, conf, kp_ref, conf_ref, 2)
    grad, grad_ref, _, _ = _decode_grads(hm, 2, seed=3)
    scale = float(grad_ref.abs().max())
    assert scale > 0 and bool(torch.isfinite(grad).all())
    assert float((grad - grad_ref).abs().max()) <= GRAD_REL_TOL * scale


def test_context_predict_step_on_card_matches_cpu(cuda_device):
    """The context model's predict step, fp32, card (normalize once, decode
    twice) against the CPU, on a 12-frame sequence (8 windows) and on
    5-frame stacks."""
    torch.manual_seed(1)
    model = build_model("heatmap_mhcrnn", "resnet18", 5).eval()
    cpu = PredictStep(model, 128, 128, torch.float32)
    card = PredictStep(build_model("heatmap_mhcrnn", "resnet18", 5), 128, 128, torch.float32)
    card.model.load_state_dict(model.state_dict())
    card.model = card.model.eval().to(cuda_device, memory_format=torch.channels_last)
    for frames in (_frames((12, 128, 128, 3), seed=1), _frames((3, 5, 128, 128, 3), seed=2)):
        bbox = torch.tensor([[0.0, 0.0, 120.0, 160.0]] * frames.shape[0])
        before = (normalize_kernel.launches, decode_kernel.launches)
        kp, conf = card(frames.to(cuda_device), bbox.to(cuda_device))
        torch.cuda.synchronize()
        assert (normalize_kernel.launches, decode_kernel.launches) == (before[0] + 1, before[1] + 2)
        kp_ref, conf_ref = cpu(frames, bbox)
        assert kp.shape == kp_ref.shape == (frames.shape[0] - 4 if frames.ndim == 4 else 3, 10)
        torch.testing.assert_close(kp.cpu(), kp_ref, rtol=0, atol=KP_TOL_PX)
        torch.testing.assert_close(conf.cpu(), conf_ref, rtol=0, atol=CONF_TOL)


def test_one_context_semisupervised_step_on_card_launches_the_kernels(cuda_device):
    """A resnet18 context step on the card (bf16): 4 stacks with dlc and an
    8-frame window (4 windows); the warp twice (stacks, window), the decode
    forward three times (both heads' labeled maps in one launch, then each
    head's window maps) and its backward twice; finite losses."""
    from lightning_pose_tpu_torch.config import load_config
    from lightning_pose_tpu_torch.losses.factory import LossFactory
    from lightning_pose_tpu_torch.ops.video_augment import sample_video_draws
    from lightning_pose_tpu_torch.train import trainer

    cfg = load_config()
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 128
    cfg.training.max_epochs = 2
    cfg.training.unfreezing_epoch = 0
    cfg.callbacks.anneal_weight.freeze_until_epoch = 0
    cfg.callbacks.anneal_weight.init_val = 1.0
    torch.manual_seed(0)
    model = build_model("heatmap_mhcrnn", "resnet18", 5).to(cuda_device, memory_format=torch.channels_last)
    optimizer, head_sched, bb_sched = trainer.make_optimizer(cfg, 10, model)
    state = trainer.TrainState(model=model, optimizer=optimizer)
    engine = AugmentationEngine("dlc", 128, 128)
    factories = {
        "supervised": LossFactory({"heatmap_mse": {"log_weight": 0.0}}),
        "unsupervised": LossFactory({"temporal": {"log_weight": 0.0}}),
    }
    step = trainer.make_step_fns({"model_type": "heatmap_mhcrnn", "downsample_factor": 2}, factories,
                                 engine, cfg, head_sched, bb_sched, 10)[2]
    rng = np.random.default_rng(6)
    cache = {
        "images": _frames((6, 5, 128, 128, 3), seed=3),
        "keypoints": torch.from_numpy(rng.uniform(0, 128, (6, 5, 2)).astype(np.float32)),
        "visibility": torch.full((6, 5), 2, dtype=torch.int64),
        "bbox": torch.tensor([[0.0, 0.0, 128.0, 128.0]] * 6),
    }
    cache = {k: v.to(cuda_device) for k, v in cache.items()}
    window = {"frames": _frames((8, 128, 128, 3), seed=4).to(cuda_device),
              "bbox": torch.tensor([[0.0, 0.0, 120.0, 160.0]] * 8, device=cuda_device)}
    gen, field_gen = torch.Generator().manual_seed(2), torch.Generator(cuda_device).manual_seed(2)
    draws = engine.sample(gen, 4, field_gen)
    video_draws = sample_video_draws(gen, 8, 128, 128, field_gen)
    before = (warp_kernel.launches, decode_kernel.launches, decode_kernel.grad_launches)
    logs = step(state, cache, torch.arange(4, device=cuda_device), torch.ones(4, dtype=torch.bool, device=cuda_device),
                draws, window, video_draws)
    torch.cuda.synchronize()
    after = (warp_kernel.launches, decode_kernel.launches, decode_kernel.grad_launches)
    assert tuple(a - b for a, b in zip(after, before)) == (2, 3, 2)
    assert bool(torch.isfinite(logs["total_loss"])) and bool(torch.isfinite(logs["train_unsupervised_loss"]))
    assert state.step == 1


# -- the multiview transformer's shapes ------------------------------------------------


def _multiview_model(keypoints=17, image=256, head_scale=300.0):
    """A random-init multiview transformer (vits_dino, 2 views), its head's
    deconv scaled so that the maps are peaked."""
    torch.manual_seed(0)
    model = build_model("heatmap_multiview", "vits_dino", keypoints, num_views=2, image_size=image)
    with torch.no_grad():
        model.head.deconv0.weight.mul_(head_scale)
    return model


@pytest.mark.parametrize("shape", [(96, 2, 256, 256, 3), (3, 2, 64, 96, 3)])
def test_normalize_kernel_on_multiview_batches_matches_plain(cuda_device, shape):
    """One launch over all views of ``(B, V, H, W, 3)``; ``(B, V, 3, H, W)``
    out, within 1 bf16 ulp of the plain version, and reshapeable to the
    model's ``(B*V, 3, H, W)`` channels-last view without a copy."""
    frames = _frames(shape, seed=11).to(cuda_device)
    before = normalize_kernel.launches
    out = normalize_kernel.normalize(frames, torch.bfloat16)
    ref = normalize_kernel.normalize_plain(frames, torch.bfloat16)
    torch.cuda.synchronize()
    assert normalize_kernel.launches == before + 1
    assert out.shape == ref.shape == (shape[0], shape[1], 3, shape[2], shape[3])
    assert _bf16_ulps(out, ref) <= 1
    flat = out.reshape(shape[0] * shape[1], 3, shape[2], shape[3])
    assert flat.data_ptr() == out.data_ptr() and flat.is_contiguous(memory_format=torch.channels_last)


def test_warp_kernel_over_view_images_matches_plain(cuda_device):
    """16 samples x 2 views folded into 32 images, one field each (one draw
    per view image)."""
    engine = AugmentationEngine("dlc", 256, 256)
    draws = _forced_draws(engine, 32)
    _, coords, _, _ = engine.sampling_grid(draws, 32, cuda_device)
    images = _frames((32, 256, 256, 3), seed=12).to(cuda_device, torch.float32)
    out = warp_kernel.warp(images, coords.contiguous())
    ref = warp_kernel.warp_plain(images, coords.contiguous())
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=GRAY_TOL)


def test_decode_and_backward_on_multiview_maps_match_plain(cuda_device):
    """The decode and its backward on a multiview model's (32, 34, 64, 64)
    maps (2 views x 17 keypoints), against the plain decode and autograd of
    it."""
    model = _multiview_model().to(cuda_device).eval()
    views = _frames((32, 2, 256, 256, 3), seed=13).to(cuda_device)
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        hm = model(normalize_kernel.normalize(views, torch.bfloat16)).float().contiguous()
    assert hm.shape == (32, 34, 64, 64)
    kp, conf = decode_kernel.decode(hm, 2)
    kp_ref, conf_ref = decode_kernel.decode_plain(hm, 2)
    _assert_decode_close(kp, conf, kp_ref, conf_ref, 2)
    grad, grad_ref, _, _ = _decode_grads(hm, 2, seed=4)
    scale = float(grad_ref.abs().max())
    assert scale > 0 and bool(torch.isfinite(grad).all())
    assert float((grad - grad_ref).abs().max()) <= GRAD_REL_TOL * scale


def test_multiview_forward_with_grad_on_cuda_gives_keypoints_with_a_gradient(cuda_device):
    """vits_dino on 2 views at 256 px in bf16 under grad: the decode kernel
    and its backward launch once each, and every ViT parameter but the
    unused CLS token gets a finite gradient."""
    model = _multiview_model().to(cuda_device, memory_format=torch.channels_last).train()
    views = _frames((2, 2, 256, 256, 3), seed=14).to(cuda_device)
    before = (decode_kernel.launches, decode_kernel.grad_launches)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        hm = model(normalize_kernel.normalize(views, torch.bfloat16))
    kp, _ = model.decode(hm)
    assert kp.grad_fn is not None and kp.shape == (2, 68)
    kp.sum().backward()
    torch.cuda.synchronize()
    assert (decode_kernel.launches - before[0], decode_kernel.grad_launches - before[1]) == (1, 1)
    for name, p in model.named_parameters():
        if name == "backbone.cls_token":
            assert p.grad is None
        else:
            assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name


def test_multiview_predict_step_on_card_matches_cpu(cuda_device):
    """The multiview predict step, fp32, card (normalize once over both
    views, decode once over 2 x 5 maps) against the CPU; each view's
    keypoints through its own bbox."""
    model = _multiview_model(keypoints=5, image=128).eval()
    cpu = PredictStep(model, 128, 128, torch.float32)
    card_model = _multiview_model(keypoints=5, image=128)
    card_model.load_state_dict(model.state_dict())
    card = PredictStep(card_model.eval().to(cuda_device, memory_format=torch.channels_last), 128, 128, torch.float32)
    frames = _frames((3, 2, 128, 128, 3), seed=15)
    bbox = torch.tensor([[0.0, 0.0, 120.0, 160.0, 5.0, 7.0, 90.0, 100.0]] * 3)
    before = (normalize_kernel.launches, decode_kernel.launches)
    kp, conf = card(frames.to(cuda_device), bbox.to(cuda_device))
    torch.cuda.synchronize()
    assert (normalize_kernel.launches, decode_kernel.launches) == (before[0] + 1, before[1] + 1)
    kp_ref, conf_ref = cpu(frames, bbox)
    assert kp.shape == kp_ref.shape == (3, 20)
    torch.testing.assert_close(kp.cpu(), kp_ref, rtol=0, atol=KP_TOL_PX)
    torch.testing.assert_close(conf.cpu(), conf_ref, rtol=0, atol=CONF_TOL)


def test_one_multiview_semisupervised_step_on_card_launches_the_kernels(cuda_device):
    """A vits_dino multiview step on the card (bf16, 128 px): 4 samples x 2
    views with dlc and the patch mask, and an 8-frame 2-view window
    (photometric only): the warp once (the view images), the decode forward
    twice (labeled, window) and its backward once; finite losses."""
    from lightning_pose_tpu_torch.config import load_config
    from lightning_pose_tpu_torch.losses.factory import LossFactory
    from lightning_pose_tpu_torch.ops.video_augment import sample_video_draws
    from lightning_pose_tpu_torch.train import trainer

    cfg = load_config()
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 128
    cfg.training.max_epochs = 2
    cfg.training.unfreezing_epoch = 0
    cfg.training.patch_mask = {"init_step": 0, "final_step": 4, "init_ratio": 0.2, "final_ratio": 0.5}
    cfg.callbacks.anneal_weight.freeze_until_epoch = 0
    cfg.callbacks.anneal_weight.init_val = 1.0
    model = _multiview_model(keypoints=5, image=128).to(cuda_device, memory_format=torch.channels_last)
    optimizer, head_sched, bb_sched = trainer.make_optimizer(cfg, 10, model)
    state = trainer.TrainState(model=model, optimizer=optimizer)
    engine = AugmentationEngine("dlc", 128, 128)
    factories = {
        "supervised": LossFactory({"heatmap_mse": {"log_weight": 0.0}}),
        "unsupervised": LossFactory({"temporal": {"log_weight": 0.0}}),
    }
    meta = {"model_type": "heatmap_multiview", "downsample_factor": 2, "num_views": 2}
    step = trainer.make_step_fns(meta, factories, engine, cfg, head_sched, bb_sched, 10)[2]
    rng = np.random.default_rng(7)
    cache = {
        "images": _frames((6, 2, 128, 128, 3), seed=16),
        "keypoints": torch.from_numpy(rng.uniform(0, 128, (6, 10, 2)).astype(np.float32)),
        "visibility": torch.full((6, 10), 2, dtype=torch.int64),
        "bbox": torch.tensor([[0.0, 0.0, 128.0, 128.0] * 2] * 6),
    }
    cache = {k: v.to(cuda_device) for k, v in cache.items()}
    window = {"frames": _frames((8, 2, 128, 128, 3), seed=17).to(cuda_device),
              "bbox": torch.tensor([[0.0, 0.0, 120.0, 160.0] * 2] * 8, device=cuda_device)}
    gen, field_gen = torch.Generator().manual_seed(2), torch.Generator(cuda_device).manual_seed(2)
    draws = engine.sample(gen, 8, field_gen)
    video_draws = sample_video_draws(gen, 16, 128, 128, field_gen)
    scores = trainer.sample_mask_scores(field_gen, 8, (128, 128))
    before = (warp_kernel.launches, decode_kernel.launches, decode_kernel.grad_launches)
    logs = step(state, cache, torch.arange(4, device=cuda_device), torch.ones(4, dtype=torch.bool, device=cuda_device),
                draws, window, video_draws, scores)
    torch.cuda.synchronize()
    after = (warp_kernel.launches, decode_kernel.launches, decode_kernel.grad_launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 2, 1)
    assert bool(torch.isfinite(logs["total_loss"])) and bool(torch.isfinite(logs["train_unsupervised_loss"]))
    assert state.step == 1


# -- EfficientNet, regression, pretrained backbones and resume ----------------------------


@pytest.mark.parametrize("model_type, backbone", [("heatmap", "efficientnet_b0"), ("regression", "resnet18"),
                                                  ("regression", "efficientnet_b0")])
def test_efficientnet_and_regression_predict_frame_on_card_match_cpu(cuda_device, tmp_path, model_type, backbone):
    """``Model.predict_frame`` at fp32 (TF32 off) on the card against the
    CPU, from one directory; a regression model's confidences are 1.0."""
    import yaml

    from lightning_pose_tpu_torch.api.model import Model
    from lightning_pose_tpu_torch.train.checkpoints import save_module

    torch.manual_seed(0)
    model = build_model(model_type, backbone, 4)
    if model_type == "heatmap":
        with torch.no_grad():
            for name in ("deconv0", "deconv1"):
                getattr(model.head, name).weight.mul_(300.0)
    ckpt_dir = tmp_path / "tb_logs" / "cardtest" / "version_0" / "checkpoints"
    ckpt_dir.mkdir(parents=True)
    save_module(str(ckpt_dir / "epoch=0-step=0-best.ckpt"), model, 0, 0)
    cfg = {"data": {"image_resize_dims": {"height": 128, "width": 128}, "num_keypoints": 4,
                    "keypoint_names": [f"kp{i}" for i in range(4)]},
           "model": {"model_type": model_type, "backbone": backbone, "model_name": "cardtest", "losses_to_use": []},
           "eval": {}}
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(cfg))
    frame = _frames((1, 150, 170, 3), seed=4)[0].numpy()
    out = {d: Model.from_dir(tmp_path, precision="fp32", device=d).predict_frame(frame, bbox=(5, 10, 140, 120))
           for d in ("cuda", "cpu")}
    np.testing.assert_allclose(out["cuda"]["keypoints"], out["cpu"]["keypoints"], rtol=0, atol=KP_TOL_PX)
    np.testing.assert_allclose(out["cuda"]["confidence"], out["cpu"]["confidence"], rtol=0, atol=CONF_TOL)
    if model_type == "regression":
        assert (out["cuda"]["confidence"] == 1.0).all()


@pytest.mark.parametrize("arch", ["resnet50_animal_ap10k", "efficientnet_b0"])
def test_pretrained_backbone_loads_on_cuda(cuda_device, tmp_path, arch):
    """A backbone on the card takes a torchvision/MMPose-layout file; the
    card's forward agrees with the CPU's at fp32."""
    from lightning_pose_tpu_torch.models.backbones.factory import build_backbone
    from lightning_pose_tpu_torch.models.backbones.pretrained import load_backbone_checkpoint
    from lightning_pose_tpu_torch.utils.synthetic import (
        torchvision_efficientnet_state_dict,
        torchvision_resnet_state_dict,
    )

    if arch.startswith("resnet"):
        torch.save({"state_dict": {f"backbone.{k}": v for k, v in torchvision_resnet_state_dict(seed=1).items()}},
                   tmp_path / "w.pth")
    else:
        torch.save(torchvision_efficientnet_state_dict("b0", seed=1), tmp_path / "w.pth")
    cpu = build_backbone(arch)[0].eval()
    card = build_backbone(arch)[0].to(cuda_device, memory_format=torch.channels_last).eval()
    for backbone in (cpu, card):
        load_backbone_checkpoint(backbone, arch, str(tmp_path / "w.pth"), image_size=128)
    assert all(p.is_cuda for p in card.parameters())
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 3, 128, 128)).astype(np.float32))
    with torch.no_grad():
        ref = cpu(x)
        out = card(x.to(cuda_device).contiguous(memory_format=torch.channels_last)).cpu()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-3 * float(ref.abs().max()))


def test_resumed_run_on_card_continues_the_run(cuda_device, tmp_path):
    """train() of 2 epochs on the card, resumed to 4: the same version
    directory, one -last.ckpt, the optimizer's state and the step carried,
    the kernels launched in the resumed epochs, finite weights."""
    from lightning_pose_tpu_torch.config import load_config
    from lightning_pose_tpu_torch.train.checkpoints import load_checkpoint
    from lightning_pose_tpu_torch.train.trainer import train
    from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset

    names = ["a", "b", "c"]
    data = write_labeled_dataset(tmp_path / "data", 10, 130, 140, names, seed=1)
    cfg = load_config()
    cfg.data.data_dir = str(data)
    cfg.data.video_dir = "videos"
    cfg.data.num_keypoints = 3
    cfg.data.keypoint_names = names
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 128
    cfg.model.backbone = "resnet18"
    cfg.model.model_name = "cardresume"
    cfg.training.train_batch_size = cfg.training.val_batch_size = 4
    cfg.training.train_prob, cfg.training.val_prob = 0.8, 0.2  # 8 train frames: 2 steps an epoch
    cfg.training.max_epochs = cfg.training.min_epochs = 2
    cfg.training.unfreezing_epoch = 0
    cfg.training.lr_scheduler_params.multisteplr.milestones = [2]
    cfg.training.check_val_every_n_epoch = 1
    train(cfg.copy(), tmp_path / "model", skip_evaluation=True)
    cfg.training.max_epochs = cfg.training.min_epochs = 4
    cfg.training.resume = True
    warps = warp_kernel.launches
    result = train(cfg, tmp_path / "model", skip_evaluation=True)
    assert warp_kernel.launches - warps == 4  # one a step of the 2 resumed epochs
    lasts = list((tmp_path / "model" / "tb_logs" / "cardresume" / "version_0" / "checkpoints").glob("*-last.ckpt"))
    assert len(lasts) == 1 and "epoch=3-step=8" in lasts[0].name
    assert not (tmp_path / "model" / "tb_logs" / "cardresume" / "version_1").exists()
    ckpt = load_checkpoint(str(lasts[0]))
    assert int(ckpt["opt_state"]["inner_states"]["head"]["inner_state"]["0"]["count"]) == 8
    assert {h["epoch"] for h in result.history} == {2, 3}
    assert all(bool(torch.isfinite(p).all()) for p in result.model.parameters())
