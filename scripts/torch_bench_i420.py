"""The PyTorch port's I420 kernel against its alternative grids, on one CUDA
card (a development bench of the port, not part of it).

Run from the root of a checkout:  python3 scripts/torch_bench_i420.py

At the predict batch ((96, 384, 256) uint8 I420, normalized bf16 and fp32)
and the unlabeled window ((32, 384, 256), RGB fp32), it times:
- ``shipped``: ``ops/yuv_kernel.py`` (a program a block of 256 pixels of
  one image row, 2 warps; the image, row and column from the program ids);
- ``pixel grid``: a program a block of 1024 pixels of the flat pixel index
  (4 warps), each lane dividing its index by the plane and the width;
- ``flat output``: a program a block of output elements (1024, 4 warps), a
  lane an element, contiguous stores and three gathered loads an element.
Each is checked against the shipped kernel's output, and timed one launch
at a time with the L2 evicted before each launch (``chip_smoke.flushed_ms``),
in 5 rounds that rotate the order, beside the bound (the bytes at the HBM
rate ``chip_smoke.py`` uses). Prints the medians, the share of the bound
and the card's name and power limit. About 40 s of command time.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def kernels():
    """The two alternative grids, in Triton."""
    import triton
    import triton.language as tl

    @triton.jit
    def pixel_grid(yuv_ptr, out_ptr, n_pixels, plane, width, s0, s1, s2, b0, b1, b2,
                   NORMALIZE: tl.constexpr, BLOCK: tl.constexpr):
        pix = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = pix < n_pixels
        img = pix // plane
        rem = pix - img * plane
        row = rem // width
        col = rem - row * width
        base = img * (plane + plane // 2)
        chroma = base + plane + (row // 2) * (width // 2) + col // 2
        y = tl.load(yuv_ptr + base + rem, mask=mask, other=0).to(tl.float32)
        u = tl.load(yuv_ptr + chroma, mask=mask, other=0).to(tl.float32)
        v = tl.load(yuv_ptr + chroma + plane // 4, mask=mask, other=0).to(tl.float32)
        yp = 1.1643836 * (y - 16.0)
        up = u - 128.0
        vp = v - 128.0
        r = tl.minimum(tl.maximum(yp + 1.5960268 * vp, 0.0), 255.0)
        g = tl.minimum(tl.maximum(yp - 0.3917623 * up - 0.8129676 * vp, 0.0), 255.0)
        b = tl.minimum(tl.maximum(yp + 2.0172321 * up, 0.0), 255.0)
        c = tl.arange(0, 4)[None, :]
        rgb = tl.where(c == 0, r[:, None], tl.where(c == 1, g[:, None], b[:, None]))
        if NORMALIZE:
            scale = tl.where(c == 0, s0, tl.where(c == 1, s1, s2))
            bias = tl.where(c == 0, b0, tl.where(c == 1, b1, b2))
            rgb = rgb * scale + bias
        tl.store(out_ptr + pix[:, None] * 3 + c, rgb.to(out_ptr.dtype.element_ty), mask=mask[:, None] & (c < 3))

    @triton.jit
    def flat_output(yuv_ptr, out_ptr, n_out, plane, width, s0, s1, s2, b0, b1, b2,
                    NORMALIZE: tl.constexpr, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n_out
        pix = offs // 3
        c = offs - pix * 3
        img = pix // plane
        rem = pix - img * plane
        row = rem // width
        col = rem - row * width
        base = img * (plane + plane // 2)
        chroma = base + plane + (row // 2) * (width // 2) + col // 2
        y = tl.load(yuv_ptr + base + rem, mask=mask, other=0).to(tl.float32)
        u = tl.load(yuv_ptr + chroma, mask=mask, other=0).to(tl.float32)
        v = tl.load(yuv_ptr + chroma + plane // 4, mask=mask, other=0).to(tl.float32)
        yp = 1.1643836 * (y - 16.0)
        up = u - 128.0
        vp = v - 128.0
        val = tl.where(c == 0, yp + 1.5960268 * vp,
                       tl.where(c == 1, yp - 0.3917623 * up - 0.8129676 * vp, yp + 2.0172321 * up))
        val = tl.minimum(tl.maximum(val, 0.0), 255.0)
        if NORMALIZE:
            scale = tl.where(c == 0, s0, tl.where(c == 1, s1, s2))
            bias = tl.where(c == 0, b0, tl.where(c == 1, b1, b2))
            val = val * scale + bias
        tl.store(out_ptr + offs, val.to(out_ptr.dtype.element_ty), mask=mask)

    return triton, pixel_grid, flat_output


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_bench_i420: needs a CUDA device")
    import chip_smoke as smoke
    from lightning_pose_tpu_torch.ops import yuv_kernel

    triton, pixel_grid, flat_output = kernels()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    rng = np.random.default_rng(0)
    scale, bias = yuv_kernel._scale_bias()
    for n, dtype, normalize in ((96, torch.bfloat16, True), (96, torch.float32, True), (32, torch.float32, False)):
        x = smoke.i420_batch(rng, n)
        h, w = x.shape[1] * 2 // 3, x.shape[2]

        def shipped():
            return yuv_kernel.i420_to_normalized(x, dtype) if normalize else yuv_kernel.i420_to_rgb(x)

        ref = shipped().movedim(1, -1) if normalize else shipped()
        outs = {name: torch.empty((n, h, w, 3), dtype=dtype, device="cuda") for name in ("pixel", "flat")}

        def pixel():
            out = outs["pixel"]
            pixel_grid[(triton.cdiv(n * h * w, 1024),)](x, out, n * h * w, h * w, w, *scale, *bias,
                                                        NORMALIZE=normalize, BLOCK=1024, num_warps=4)
            return out

        def flat():
            out = outs["flat"]
            flat_output[(triton.cdiv(out.numel(), 1024),)](x, out, out.numel(), h * w, w, *scale, *bias,
                                                           NORMALIZE=normalize, BLOCK=1024, num_warps=4)
            return out

        for name, fn in (("pixel grid", pixel), ("flat output", flat)):
            out = fn()
            torch.cuda.synchronize()
            print(f"{name} against shipped: max abs diff {float((out.float() - ref.float()).abs().max()):.3e}")
        rounds = smoke.flushed_rounds({"shipped": shipped, "pixel grid": pixel, "flat output": flat})
        n_bytes = x.numel() + x.numel() // 3 * 2 * 3 * (2 if dtype == torch.bfloat16 else 4)
        bound = smoke.bound_of(n_bytes, 0)[0]
        what = f"{tuple(x.shape)} -> {'normalized ' if normalize else 'RGB '}{str(dtype).split('.')[-1]}"
        for name, times in rounds.items():
            med = float(np.median(times))
            print(f"{what}: {name} median {med:.5f} ms ({bound / med:.1%} of the {bound:.5f} ms bound), "
                  f"rounds {' '.join(f'{t:.5f}' for t in times)} [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
