"""The PyTorch port's warp kernel against its alternatives, on one CUDA card
(a development bench of the port, not part of it).

Run from the root of a checkout:  python3 scripts/torch_bench_warp.py [--rounds 7]

At the product shape ((16, 256, 256, 3) fp32 images, a dlc sampling grid
whose affine, crop-pad and elastic ops all fire), it times:
- ``warp``: ``csrc/warp.cu`` as the port builds it (one pixel a thread,
  lanes on consecutive pixels, one 8-byte coordinate load, three stride-3
  scalar stores);
- ``four_strided``: 4 consecutive pixels a thread, their coordinates read as
  two 16-byte words and their 12 outputs written as three, each thread
  gathering its own pixels' taps;
- ``four_staged``: the same 16-byte reads and writes, with the coordinates
  and outputs exchanged through shared memory so that lane ``l`` gathers
  the warp's pixels ``l + 32 j`` (lane-consecutive taps);
- ``grid_sample``: ``F.grid_sample`` on the NHWC images viewed as NCHW, at
  the normalized coordinates (built outside the timed region);
- ``copy``: a device copy of as many bytes as the warp moves, half in and
  half out.
The two variants are built here from the source below, with the flags of
``ops/cuda_build.py``. Each candidate is timed one launch at a time with the
L2 evicted before each launch by a read of 512 MiB (as ``chip_smoke.py``
does), 50 launches a round; a first round is not kept, and the rounds
rotate the order of the candidates. Prints each one's round means, their
median, mean, min and max, and each kernel's largest error against
``warp_plain``.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FLUSH_BYTES = 512 * 2**20
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM

VARIANTS_SOURCE = r"""
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;  // warps per block, each on its own row

__device__ __forceinline__ bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// the 12 taps of the pixel sampled at (cx, cy), zero outside the frame, and
// its bilinear weights, as in csrc/warp.cu
__device__ __forceinline__ void taps(const float* image, int h, int w, float cx, float cy, float v[4][3],
                                     float& wx, float& wy) {
  const float fx = floorf(cx);
  const float fy = floorf(cy);
  wx = cx - fx;
  wy = cy - fy;
  const int x0 = static_cast<int>(fminf(fmaxf(fx, -2.0f), static_cast<float>(w)));
  const int y0 = static_cast<int>(fminf(fmaxf(fy, -2.0f), static_cast<float>(h)));
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int xi = x0 + (t & 1);
    const int yi = y0 + (t >> 1);
    const bool inside = xi >= 0 && xi < w && yi >= 0 && yi < h;
    const float* p = image + (static_cast<size_t>(min(max(yi, 0), h - 1)) * w + min(max(xi, 0), w - 1)) * 3;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float val = __ldg(p + ch);
      v[t][ch] = inside ? val : 0.0f;
    }
  }
}

__device__ __forceinline__ float blend(const float v[4][3], int ch, float wx, float wy) {
  const float ax = 1.0f - wx;
  const float ay = 1.0f - wy;
  return v[0][ch] * ax * ay + v[1][ch] * wx * ay + v[2][ch] * ax * wy + v[3][ch] * wx * wy;
}

// this lane's 4 pixels' coordinates from two 16-byte words (scalar reads for
// a group that is ragged or not aligned; a pixel past the row samples
// outside the frame)
__device__ __forceinline__ void read_coords(const float* cin, int n, float c[8]) {
  if (n == 4 && aligned16(cin)) {
    const float4 c01 = __ldg(reinterpret_cast<const float4*>(cin));
    const float4 c23 = __ldg(reinterpret_cast<const float4*>(cin) + 1);
    c[0] = c01.x; c[1] = c01.y; c[2] = c01.z; c[3] = c01.w;
    c[4] = c23.x; c[5] = c23.y; c[6] = c23.z; c[7] = c23.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) c[i] = i < 2 * n ? __ldg(cin + i) : -4.0f;
  }
}

// this lane's 4 pixels' 12 outputs as three 16-byte words
__device__ __forceinline__ void write_outputs(float* dst, int n, const float o[12]) {
  if (n == 4 && aligned16(dst)) {
    float4* d = reinterpret_cast<float4*>(dst);
    d[0] = make_float4(o[0], o[1], o[2], o[3]);
    d[1] = make_float4(o[4], o[5], o[6], o[7]);
    d[2] = make_float4(o[8], o[9], o[10], o[11]);
  } else {
#pragma unroll
    for (int i = 0; i < 12; ++i)
      if (i < 3 * n) dst[i] = o[i];
  }
}

__global__ void __launch_bounds__(32 * kWarps) warp_four_strided(
    const float* __restrict__ img, const float* __restrict__ coords, float* __restrict__ out, int h, int w) {
  const int q0 = (blockIdx.x * 32 + threadIdx.x) * 4;
  const int row = blockIdx.y * kWarps + threadIdx.y;
  if (q0 >= w || row >= h) return;
  const size_t pix0 = (static_cast<size_t>(blockIdx.z) * h + row) * w + q0;
  const float* image = img + static_cast<size_t>(blockIdx.z) * h * w * 3;
  const int n = min(4, w - q0);
  float c[8], v[4][4][3], wx[4], wy[4], o[12];
  read_coords(coords + 2 * pix0, n, c);
#pragma unroll
  for (int j = 0; j < 4; ++j) taps(image, h, w, c[2 * j], c[2 * j + 1], v[j], wx[j], wy[j]);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) o[3 * j + ch] = blend(v[j], ch, wx[j], wy[j]);
  write_outputs(out + 3 * pix0, n, o);
}

__global__ void __launch_bounds__(32 * kWarps) warp_four_staged(
    const float* __restrict__ img, const float* __restrict__ coords, float* __restrict__ out, int h, int w) {
  __shared__ float4 stage[kWarps][3 * 32];  // a warp's 128 pixels: coordinates, then outputs
  const int lane = threadIdx.x;
  const int row = blockIdx.y * kWarps + threadIdx.y;
  if (row >= h) return;  // the whole warp: one row
  const int q0 = (blockIdx.x * 32 + lane) * 4;
  const size_t pix0 = (static_cast<size_t>(blockIdx.z) * h + row) * w + q0;
  const float* image = img + static_cast<size_t>(blockIdx.z) * h * w * 3;
  const int n = max(0, min(4, w - q0));
  float4* s4 = stage[threadIdx.y];
  float* s = reinterpret_cast<float*>(s4);
  float c[8], v[4][4][3], wx[4], wy[4], o[12];
  read_coords(coords + 2 * pix0, n, c);
  s4[2 * lane] = make_float4(c[0], c[1], c[2], c[3]);
  s4[2 * lane + 1] = make_float4(c[4], c[5], c[6], c[7]);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 cj = reinterpret_cast<const float2*>(s)[lane + 32 * j];
    c[2 * j] = cj.x;
    c[2 * j + 1] = cj.y;
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 4; ++j) taps(image, h, w, c[2 * j], c[2 * j + 1], v[j], wx[j], wy[j]);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) s[3 * (lane + 32 * j) + ch] = blend(v[j], ch, wx[j], wy[j]);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float4 q = s4[3 * lane + k];
    o[4 * k] = q.x; o[4 * k + 1] = q.y; o[4 * k + 2] = q.z; o[4 * k + 3] = q.w;
  }
  write_outputs(out + 3 * pix0, n, o);
}

}  // namespace

extern "C" int lp_warp_variant_launch(int variant, const void* images, const void* coords, void* out, int b,
                                      int h, int w, void* stream) {
  const dim3 grid((w + 127) / 128, (h + kWarps - 1) / kWarps, b);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const float*>(images);
  const auto* c = static_cast<const float*>(coords);
  auto* o = static_cast<float*>(out);
  if (variant == 0)
    warp_four_strided<<<grid, dim3(32, kWarps), 0, s>>>(in, c, o, h, w);
  else
    warp_four_staged<<<grid, dim3(32, kWarps), 0, s>>>(in, c, o, h, w);
  return static_cast<int>(cudaGetLastError());
}
"""
VARIANTS = {"four_strided": 0, "four_staged": 1}


def flushed_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean device time of one ``fn()`` in ms, by CUDA events around each
    call alone, with the L2 evicted before each (a sum over FLUSH_BYTES)."""
    import torch

    scratch = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    total = torch.empty((), dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    for start, end in pairs:
        torch.sum(scratch, dim=0, out=total)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / iters


def build_variants() -> ctypes.CDLL:
    from lightning_pose_tpu_torch.ops import cuda_build

    out_dir = cuda_build.BUILD_DIR.parent / "bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "warp_variants.cu", out_dir / "warp_variants.so"
    src.write_text(VARIANTS_SOURCE)
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(proc.stdout + proc.stderr)
    for fn, regs in re.findall(r"entry function '\w*?(warp_four_[a-z]+).*?(Used \d+ registers)", proc.stderr, re.S):
        print(f"{fn}: {regs}")
    dll = ctypes.CDLL(str(lib))
    dll.lp_warp_variant_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    dll.lp_warp_variant_launch.restype = ctypes.c_int
    return dll


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=7)
    args = parser.parse_args()

    import torch
    import torch.nn.functional as F

    from lightning_pose_tpu_torch.ops import warp_kernel
    from lightning_pose_tpu_torch.ops.augment import AugmentationEngine

    if not torch.cuda.is_available():
        raise SystemExit("torch_bench_warp: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    b, h, w = 16, 256, 256
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)).to(dev)
    engine = AugmentationEngine("dlc", h, w)
    draws = engine.sample(torch.Generator().manual_seed(0), b, torch.Generator(device="cuda").manual_seed(0))
    for name in ("affine_u", "croppad_u", "elastic_u"):
        getattr(draws, name).zero_()
    draws.elastic_alpha.fill_(10.0)
    coords = engine.sampling_grid(draws, b, dev)[1].contiguous()

    variants_lib = build_variants()
    stream = torch.cuda.current_stream(dev).cuda_stream
    variant_out = torch.empty_like(images)

    def variant(index: int):
        def launch():
            err = variants_lib.lp_warp_variant_launch(index, images.data_ptr(), coords.data_ptr(),
                                                      variant_out.data_ptr(), b, h, w, stream)
            if err:
                raise RuntimeError(f"warp variant {index} launch failed with CUDA error {err}")
            return variant_out

        return launch

    nchw = images.permute(0, 3, 1, 2)
    grid = torch.stack([2 * coords[..., 0] / (w - 1) - 1, 2 * coords[..., 1] / (h - 1) - 1], dim=-1)

    def grid_sample():
        return F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

    n_bytes = (images.numel() * 2 + coords.numel()) * 4
    copy_src = torch.empty(n_bytes // 8, dtype=torch.float32, device=dev)
    copy_dst = torch.empty_like(copy_src)
    candidates = {
        "warp": lambda: warp_kernel.warp(images, coords),
        **{name: variant(index) for name, index in VARIANTS.items()},
        "grid_sample": grid_sample,
        "copy": lambda: copy_dst.copy_(copy_src),
    }

    ref = warp_kernel.warp_plain(images, coords)
    for name in ("warp", *VARIANTS, "grid_sample"):
        out = candidates[name]()
        out = out.permute(0, 2, 3, 1) if name == "grid_sample" else out
        print(f"{name}: max abs err {float((out - ref).abs().max()):.3e} gray against warp_plain")

    rounds: dict[str, list[float]] = {name: [] for name in candidates}
    names = list(candidates)
    for name in names:  # a first round, not kept: clocks and allocations settle
        flushed_ms(candidates[name])
    for r in range(args.rounds):
        order = names[r % len(names):] + names[: r % len(names)]
        for name in order:
            rounds[name].append(flushed_ms(candidates[name]))
    bound = n_bytes / HBM_BYTES_PER_S * 1e3
    print(f"({b}, {h}, {w}, 3) fp32, {n_bytes / 1e6:.1f} MB moved, bound {bound:.4f} ms; {args.rounds} rounds "
          f"of 50 launches, L2 flushed before each [{smi}]")
    for name, ms in rounds.items():
        a = np.asarray(ms)
        print(f"{name}: median {np.median(a):.5f} ms, mean {a.mean():.5f}, min {a.min():.5f}, max {a.max():.5f}, "
              f"{bound / np.median(a):.1%} of the bound; rounds {' '.join(f'{x:.5f}' for x in a)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
