// Tiled-CLAHE LUT blend for Hopper (sm_90a).
//
// Replaces the TPU kernel lightning_pose_tpu/ops/pallas_clahe.py
// (clahe_apply_pallas, body _clahe_kernel): the second stage of cv2's CLAHE.
// Per image-channel n, with x (H, W) pixel values 0-255 and lut (g, g, 256)
// the clip-limited per-tile LUTs, every pixel blends the four nearest tiles'
// LUTs bilinearly:
//
//   v   = (int) clamp(x[y, c], 0, 255)               (truncation)
//   top = (1 - wx) * lut[ylo][xlo][v] + wx * lut[ylo][xhi][v]
//   bot = (1 - wx) * lut[yhi][xlo][v] + wx * lut[yhi][xhi][v]
//   out = (1 - wy) * top + wy * bot
//
// Tiles are th = H/g by tw = W/g pixels, split into half-blocks of hh = th/2
// rows and hw = tw/2 columns. For the half-block row r = y / hh the tile rows
// are ylo = clamp(floor((r-1)/2), 0, g-1) and yhi = clamp(floor((r-1)/2)+1,
// 0, g-1), likewise xlo, xhi from the half-block column; the weights are
// wy = frac((y + 0.5)/th - 0.5), wx = frac((c + 0.5)/tw - 0.5). These are the
// maps _static_maps builds (pallas_clahe.py:64-78), including cv2's edge
// behaviour: at the borders the clamped corners coincide and the weights are
// moot. fp32 throughout, as the TPU kernel's HIGHEST-precision dots.
//
// What bounds it on the H100: memory traffic and shared-memory gathers. Per
// pixel it reads 4 bytes, writes 4 and makes 4 data-dependent LUT reads; the
// LUTs of one image-channel are g*g*256*4 = 256 KB at g = 16, more than a
// block's 227 KB of shared memory. What the design does about it: a block
// owns one image-channel and one half-block row r, for which only two rows of
// tiles are ever read, lut[n, ylo] and lut[n, yhi]. It stages those two rows
// (2 * g * 256 * 4 = 32 KB at g = 16) in shared memory with coalesced loads,
// then walks the half-block row's hh * W pixels with consecutive threads on
// consecutive pixels, so the pixel loads and stores are coalesced and the
// LUT reads are shared-memory gathers. The staged rows are shared by at most
// three blocks each and stay in L2.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 256;

__device__ __forceinline__ int floor_half(int a) {  // floor(a / 2) for a >= -1
  return a >= 0 ? a / 2 : -1;
}

__device__ __forceinline__ float frac(float t) { return t - floorf(t); }

__global__ void __launch_bounds__(kThreads)
clahe_blend_kernel(const float* __restrict__ x, const float* __restrict__ lut,
                   float* __restrict__ out, int H, int W, int g) {
  extern __shared__ float s_lut[];  // [2][g][kBins]: tile rows ylo, yhi
  const int r = blockIdx.x;         // half-block row
  const long n = blockIdx.y;        // image-channel
  const int th = H / g, tw = W / g;
  const int hh = th / 2, hw = tw / 2;
  const int t = floor_half(r - 1);
  const int ylo = min(max(t, 0), g - 1);
  const int yhi = min(max(t + 1, 0), g - 1);

  const int row_len = g * kBins;
  const float* lut_n = lut + n * g * row_len;
  for (int i = threadIdx.x; i < row_len; i += kThreads) {
    s_lut[i] = lut_n[ylo * row_len + i];
    s_lut[row_len + i] = lut_n[yhi * row_len + i];
  }
  __syncthreads();

  const long base = n * H * W + static_cast<long>(r) * hh * W;
  const int count = hh * W;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int y = r * hh + i / W;
    const int c = i % W;
    const float wy = frac((static_cast<float>(y) + 0.5f) / static_cast<float>(th) - 0.5f);
    const float wx = frac((static_cast<float>(c) + 0.5f) / static_cast<float>(tw) - 0.5f);
    const int tc = floor_half(c / hw - 1);
    const int xlo = min(max(tc, 0), g - 1);
    const int xhi = min(max(tc + 1, 0), g - 1);
    const int v = static_cast<int>(fminf(fmaxf(x[base + i], 0.0f), 255.0f));
    const float* lo = s_lut;
    const float* hi = s_lut + row_len;
    const float top = (1.0f - wx) * lo[xlo * kBins + v] + wx * lo[xhi * kBins + v];
    const float bot = (1.0f - wx) * hi[xlo * kBins + v] + wx * hi[xhi * kBins + v];
    out[base + i] = (1.0f - wy) * top + wy * bot;
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs for a g x g tile grid.
size_t lp_clahe_smem_bytes(int g) {
  return sizeof(float) * 2 * static_cast<size_t>(g) * kBins;
}

// Launches the blend of n image-channels of (H, W) pixels on `stream` of
// `device`; returns the first CUDA error (cudaGetLastError() after the
// launch), 0 if none. The caller checks H % (2g) == 0 and W % (2g) == 0.
int lp_clahe_launch(const void* x, const void* lut, void* out, int n, int H, int W, int g,
                    int device, void* stream) {
  const size_t smem = lp_clahe_smem_bytes(g);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      clahe_blend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(2 * g, n);
  clahe_blend_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(lut), static_cast<float*>(out),
      H, W, g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
