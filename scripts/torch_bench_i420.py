"""The PyTorch port's I420 kernel against its other design and its first
one, on one CUDA card (a development bench of the port, not part of it).

Run from the root of a checkout:  python3 scripts/torch_bench_i420.py

It builds ``lightning_pose_tpu_torch/csrc/i420.cu`` twice more by hand, with
``-Xptxas -v`` (registers, shared memory, spills are printed): with
``-DLP_I420_STAGED=1``, as it ships (a warp's row staged in shared memory
and written lane-contiguously), and with ``=0`` (16-byte stores straight
from registers). At the predict batch ((96, 384, 256) uint8 I420,
normalized bf16 and fp32) and the unlabeled window ((32, 384, 256), RGB
fp32), it times:
- ``shipped``: ``ops/yuv_kernel.py`` as the port calls it;
- ``registers`` and ``staged``: the two store schemes, launched by hand;
- ``scalar path``: the shipped wrapper on an input view at a 1-byte offset,
  which takes the kernel's scalar path (byte loads, one store an element);
- ``first design``: the kernel as it was first written, in Triton (a
  program a block of 256 pixels of one image row, 2 warps, a masked
  (256, 4) output tile).
Each is checked against the shipped kernel's output, and timed one launch
at a time with the L2 evicted before each launch (``chip_smoke.flushed_ms``),
in 5 rounds that rotate the order, beside the bound (the bytes at the HBM
rate ``chip_smoke.py`` uses). Prints the medians, the share of the bound
and the card's name and power limit. About a minute of command time.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def first_design():
    """The first design of the kernel, in Triton, as it shipped before the
    CUDA kernel."""
    import triton
    import triton.language as tl

    @triton.jit
    def i420_kernel(
        yuv_ptr, out_ptr, height, width,
        s0, s1, s2, b0, b1, b2,
        NORMALIZE: tl.constexpr, BLOCK_W: tl.constexpr,
    ):
        image_row = tl.program_id(0)  # image * height + row
        img = image_row // height
        row = image_row - img * height
        col = tl.program_id(1) * BLOCK_W + tl.arange(0, BLOCK_W)
        mask = col < width
        plane = height * width
        base = img * (plane + plane // 2)
        chroma = base + plane + (row // 2) * (width // 2) + col // 2
        y = tl.load(yuv_ptr + base + row * width + col, mask=mask, other=0).to(tl.float32)
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
        pix = image_row * width + col
        tl.store(out_ptr + pix[:, None] * 3 + c, rgb.to(out_ptr.dtype.element_ty),
                 mask=mask[:, None] & (c < 3))

    return triton, i420_kernel


def build_variant(staged: int) -> ctypes.CDLL:
    """``csrc/i420.cu`` built with ``-DLP_I420_STAGED=<staged>`` and
    ``-Xptxas -v`` into ``build/kernels/variants/``; prints what ptxas says."""
    from lightning_pose_tpu_torch.ops import cuda_build, yuv_kernel

    out_dir = cuda_build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"i420_staged{staged}.so"
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-DLP_I420_STAGED={staged}", "-Xptxas", "-v",
           "-o", str(lib_path), str(cuda_build.CSRC_DIR / "i420.cu")]
    log = subprocess.run(cmd, capture_output=True, text=True, check=True)
    for line in (log.stdout + log.stderr).splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"ptxas (LP_I420_STAGED={staged}): {line.strip()}")
    return yuv_kernel._bind(ctypes.CDLL(str(lib_path)))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_bench_i420: needs a CUDA device")
    import chip_smoke as smoke
    from lightning_pose_tpu_torch.ops import yuv_kernel

    triton, triton_kernel = first_design()
    variants = {"registers": build_variant(0), "staged": build_variant(1)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    rng = np.random.default_rng(0)
    scale, bias = yuv_kernel._scale_bias()
    stream = torch.cuda.current_stream().cuda_stream
    for n, dtype, normalize in ((96, torch.bfloat16, True), (96, torch.float32, True), (32, torch.float32, False)):
        x = smoke.i420_batch(rng, n)
        h, w = x.shape[1] * 2 // 3, x.shape[2]
        # the same bytes at a 1-byte offset: the kernel's scalar path
        shifted = torch.empty(x.numel() + 1, dtype=torch.uint8, device="cuda")[1:].view(x.shape)
        shifted.copy_(x)
        if normalize:
            epilogue = yuv_kernel._NORMALIZED_BF16 if dtype == torch.bfloat16 else yuv_kernel._NORMALIZED_FP32
        else:
            epilogue = yuv_kernel._RGB_FP32

        def shipped(src=x):
            return yuv_kernel.i420_to_normalized(src, dtype).movedim(1, -1) if normalize else yuv_kernel.i420_to_rgb(src)

        ref = shipped()
        outs = {name: torch.empty((n, h, w, 3), dtype=dtype, device="cuda") for name in (*variants, "triton")}

        def by_hand(name):
            def run():
                out = outs[name]
                err = variants[name].lp_i420_launch(x.data_ptr(), out.data_ptr(), n, h, w, epilogue,
                                                    *scale, *bias, 0, stream)
                assert err == 0, f"{name}: CUDA error {err}"
                return out
            return run

        def first():
            out = outs["triton"]
            triton_kernel[(n * h, triton.cdiv(w, 256))](x, out, h, w, *scale, *bias,
                                                        NORMALIZE=normalize, BLOCK_W=256, num_warps=2)
            return out

        fns = {"shipped": shipped, "registers": by_hand("registers"), "staged": by_hand("staged"),
               "scalar path": lambda: shipped(shifted), "first design": first}
        for name, fn in fns.items():
            if name == "shipped":
                continue
            out = fn()
            torch.cuda.synchronize()
            print(f"{name} against shipped: max abs diff {float((out.float() - ref.float()).abs().max()):.3e}")
        rounds = smoke.flushed_rounds(fns)
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
