// Bilinear warp of images at per-pixel coordinates, for Hopper (sm_90a).
//
// Replaces the TPU kernel lightning_pose_tpu/ops/pallas_warp.py
// (warp_bilinear_pallas, body _warp_kernel). It computes what the
// reference's grid_sample_bilinear (lightning_pose_tpu/ops/augment.py:50-82)
// computes: for every output pixel, floor the (x, y) coordinate, form the
// four bilinear weights in fp32, read the four neighbouring pixels of each
// channel (zero outside the frame) and sum them in the reference's order
//
//     v00 (1-wx)(1-wy) + v01 wx (1-wy) + v10 (1-wx) wy + v11 wx wy.
//
// The TPU kernel did this as one-hot row-weight matmuls over a row window in
// bf16, because a TPU gathers one element at a time; a GPU gathers natively,
// so none of that is carried over.
//
// What bounds it on the H100: device memory. Each output pixel reads 8 bytes
// of coordinates and writes 12 bytes; its 12 taps hit L1/L2 after the
// first touch, since neighbouring pixels sample neighbouring rows. At the
// product shape ((16, 256, 256, 3) fp32) the image, the coordinates and the
// output are 33.6 MB, 10.0 us at 3.35 TB/s; a plain device copy of as many
// bytes is the practical floor (chip_smoke.py times both). There is no
// matmul and nothing worth staging.
//
// What the design does about it: it keeps as many loads in flight as the
// card takes, and every access of a warp on consecutive words.
// - One thread per output pixel, lanes on consecutive pixels of a row: the
//   (x, y) pair is one 8-byte load, the 12 taps of a warp touch few cache
//   lines, and each of the three stores of a warp fills its lines with the
//   other two. 4 warps a block, one row each; the grid runs over (group of
//   32 columns, group of 4 rows, image), so there is no division.
// - All 12 taps are issued before any is used (clamped addresses, zeroed
//   after the load), through the read-only path.
// - 4 consecutive pixels a thread with 16-byte coordinate loads and output
//   stores is slower on the H100: gathered by the thread that owns them,
//   a warp's taps of one tap slot spread over 4x the cache lines (L1
//   wavefronts); gathered lane-consecutively and exchanged through shared
//   memory, the exchange costs more than the wide accesses save, since the
//   L2 merges the stride-3 stores of a warp into whole lines.
//   scripts/torch_bench_warp.py times both against this kernel,
//   F.grid_sample and a device copy, with the L2 flushed.
// - The weights and the sum keep the reference's order, so the kernel stays
//   within rounding (fp32 FMA contraction) of the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // warps per block, each on its own row

__global__ void __launch_bounds__(32 * kWarps) warp_kernel(
    const float* __restrict__ img,     // (B, H, W, 3)
    const float* __restrict__ coords,  // (B, H, W, 2), (x, y) in input pixels
    float* __restrict__ out,           // (B, H, W, 3)
    int h, int w) {
  const int q = blockIdx.x * 32 + threadIdx.x;
  const int row = blockIdx.y * kWarps + threadIdx.y;
  if (q >= w || row >= h) return;
  const int b = blockIdx.z;
  const size_t pix = (static_cast<size_t>(b) * h + row) * w + q;
  const float* image = img + static_cast<size_t>(b) * h * w * 3;

  const float2 c = __ldg(reinterpret_cast<const float2*>(coords) + pix);
  const float fx = floorf(c.x);
  const float fy = floorf(c.y);
  const float wx = c.x - fx;
  const float wy = c.y - fy;
  // floats beyond int range (a coordinate far outside the frame) land
  // outside the frame either way
  const int x0 = static_cast<int>(fminf(fmaxf(fx, -2.0f), static_cast<float>(w)));
  const int y0 = static_cast<int>(fminf(fmaxf(fy, -2.0f), static_cast<float>(h)));
  float v[4][3];  // [tap 00, 01, 10, 11][channel]
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
  const float ax = 1.0f - wx;
  const float ay = 1.0f - wy;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    out[3 * pix + ch] = v[0][ch] * ax * ay + v[1][ch] * wx * ay + v[2][ch] * ax * wy + v[3][ch] * wx * wy;
}

}  // namespace

extern "C" {

// Launches the warp of a (B, H, W, 3) image batch on `stream` of `device`;
// returns the first CUDA error (cudaGetLastError() after the launch), 0 if none.
int lp_warp_launch(const void* images, const void* coords, void* out, int b, int h, int w,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + 31) / 32, (h + kWarps - 1) / kWarps, b);
  warp_kernel<<<grid, dim3(32, kWarps), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(images), static_cast<const float*>(coords),
      static_cast<float*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
