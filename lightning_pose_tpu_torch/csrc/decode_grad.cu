// Backward of the fused soft-argmax decode for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package trains through its XLA decode
// (lightning_pose_tpu/ops/softargmax.py:123-147) and differentiates it by
// XLA's autodiff. The forward here is decode.cu; per (frame, keypoint)
// heatmap `hm` of shape (h, w) it computed
//
//   up   = Mh @ hm @ Mw^T          (H, W)
//   z    = temperature * up,  p = softmax(z) over all H*W pixels
//   x, y = sum(p * col), sum(p * row)
//
// and, for this kernel, lse2 = max(z') + log2(sum 2^(z' - max)) of the
// base-2 logits z' = z * log2(e). Given gx, gy, the gradients of the map's
// keypoint (the grid offset is a constant), this kernel computes
//
//   dup[r][c] = temperature * p[r][c] * (gx * (c - x) + gy * (r - y))
//   dhm       = Mh^T @ dup @ Mw
//
// with p = 2^(z' - lse2) recomputed from hm. The confidence is not
// differentiated (the losses read it only through a threshold).
//
// What bounds it on the H100: fp32 FMAs, about twice the forward's (T and up
// recomputed, then dup @ Mw and Mh^T @ that), never TF32: the temperature
// of 1000 multiplies any error in up. Each map is 16 KB in and 16 KB out at
// the product shape (64x64 maps to 256x256).
//
// Layout (a simple design that is right, not yet a fast one): one block of
// 256 threads per map, everything in shared memory (120 KB at the product
// shape, one block an SM):
// - the map, every row tile's Mh band (decode.cu's packing) and the Mw
//   bands (band-major, decode.cu's packing) are staged;
// - T = hm @ Mw^T over Mw's bands, in decode.cu's FMA order, so T and up
//   are bitwise the forward's;
// - then chunks of kChunk output rows: up in 4x4 register tiles, p and dup
//   into shared memory; u = dup @ Mw for the chunk's rows, each (row, j)
//   summed over the column tiles whose Mw band holds j; and the (h, w)
//   accumulator += Mh^T @ u through the chunk's row tiles' Mh bands. Each
//   thread owns the accumulator entries it adds to, so the sums are in a
//   fixed order: no atomics, the same result every run.
// - the accumulator, which held the map until T was built, is written out.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;      // rows of an Mh row tile (decode.cu's kRows)
constexpr int kCols = 4;      // columns of an Mw column tile (decode.cu's kCols)
constexpr int kMaxBand = 10;  // widest Mw band (decode.cu's kMaxBand)
constexpr int kChunk = 16;    // output rows a pass over dup covers
static_assert(kChunk % kRows == 0, "a chunk holds whole row tiles");

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__global__ void __launch_bounds__(kThreads) decode_grad_kernel(
    const float* __restrict__ maps,       // (N, h, w)
    const float* __restrict__ keypoints,  // (N, 2): x - offset, y - offset
    const float* __restrict__ lse2,       // (N,)
    const float* __restrict__ grad_kp,    // (N, 2): gx, gy
    const float* __restrict__ mh_tiles,   // (n_tiles, tile_band, kRows): Mh[kRows*t + r][lo(t) + k] at [t][k][r]
    const float* __restrict__ mw_packed,  // (kMaxBand, Wp/kCols, kCols): Mw[kCols*ct + c][lo(ct) + k] at [k][ct][c]
    const int* __restrict__ mh_band,      // (n_tiles, 2): [lo, hi) of the Mh columns of row tile t
    const int* __restrict__ mw_band,      // (Wp/kCols, 2): [lo, hi) of the Mw columns of column tile ct
    const int* __restrict__ mw_cols,      // (w, 2): [lo, hi) of the column tiles whose band holds j
    float* __restrict__ grad_maps,        // (N, h, w)
    int h, int w, int H, int W, int Wp, int tile_band, float scale, float temperature, float offset) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int map = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_tiles = (H + kRows - 1) / kRows;
  const int groups = Wp / kCols;

  float* s_mh = smem;                               // (n_tiles, tile_band, kRows)
  float* s_mw = s_mh + n_tiles * tile_band * kRows;  // (kMaxBand, groups, kCols)
  float* s_t = s_mw + kMaxBand * Wp;                // (h, Wp)
  float* s_dup = s_t + h * Wp;                      // (kChunk, Wp)
  float* s_u = s_dup + kChunk * Wp;                 // (kChunk, w)
  float* s_acc = s_u + kChunk * w;                  // (h, w): the map, then dhm

  const float* hm = maps + static_cast<size_t>(map) * h * w;
  for (int k = tid; k < n_tiles * tile_band * kRows; k += kThreads) s_mh[k] = mh_tiles[k];
  for (int k = tid; k < kMaxBand * Wp; k += kThreads) s_mw[k] = mw_packed[k];
  for (int k = tid; k < h * w; k += kThreads) s_acc[k] = hm[k];
  __syncthreads();

  // T[i][q] = sum_j hm[i][j] * Mw[q][j] over the Mw band of q's column tile
  for (int item = tid; item < h * groups; item += kThreads) {
    const int ct = item % groups;
    const int i = item / groups;
    const int j_lo = mw_band[2 * ct];
    const int n_j = mw_band[2 * ct + 1] - j_lo;
    const float* row = s_acc + i * w + j_lo;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int k = 0; k < n_j; ++k) {
      const float v = row[k];
      const float4 b = *reinterpret_cast<const float4*>(s_mw + (k * groups + ct) * kCols);
      acc.x = fmaf(v, b.x, acc.x);
      acc.y = fmaf(v, b.y, acc.y);
      acc.z = fmaf(v, b.z, acc.z);
      acc.w = fmaf(v, b.w, acc.w);
    }
    *reinterpret_cast<float4*>(s_t + i * Wp + ct * kCols) = acc;
  }
  __syncthreads();
  for (int k = tid; k < h * w; k += kThreads) s_acc[k] = 0.0f;

  const float gx = grad_kp[2 * map];
  const float gy = grad_kp[2 * map + 1];
  const float x = keypoints[2 * map] + offset;
  const float y = keypoints[2 * map + 1] + offset;
  const float l2 = lse2[map];
  constexpr int kTilesPerChunk = kChunk / kRows;

  for (int p0 = 0; p0 < H; p0 += kChunk) {
    // dup over the chunk's rows: a thread's 4x4 tile is rows pr..pr+3 and
    // columns q0..q0+3; pixels past the map's edge get 0
    for (int item = tid; item < kTilesPerChunk * groups; item += kThreads) {
      const int ct = item % groups;
      const int tl = item / groups;
      const int pr = p0 + tl * kRows;
      const int q0 = ct * kCols;
      float acc[kRows][kCols] = {};
      if (pr < H) {
        const int pt = pr / kRows;
        const int i_lo = mh_band[2 * pt];
        const int n_i = mh_band[2 * pt + 1] - i_lo;
        const float* band = s_mh + pt * tile_band * kRows;
        const float* t_rows = s_t + i_lo * Wp + q0;
        for (int k = 0; k < n_i; ++k) {
          const float4 a = *reinterpret_cast<const float4*>(band + k * kRows);
          const float4 t = *reinterpret_cast<const float4*>(t_rows + k * Wp);
          const float av[kRows] = {a.x, a.y, a.z, a.w};
          const float tv[kCols] = {t.x, t.y, t.z, t.w};
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(av[r], tv[c], acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = pr + r;
        float out[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int col = q0 + c;
          out[c] = 0.0f;
          if (row < H && col < W) {
            const float p = exp2_approx(fmaf(acc[r][c], scale, -l2));
            out[c] = temperature * p *
                     fmaf(gx, static_cast<float>(col) - x, gy * (static_cast<float>(row) - y));
          }
        }
        *reinterpret_cast<float4*>(s_dup + (tl * kRows + r) * Wp + q0) = make_float4(out[0], out[1], out[2], out[3]);
      }
    }
    __syncthreads();

    // u[r][j] = sum_q dup[r][q] * Mw[q][j], over the column tiles whose
    // band holds j
    for (int item = tid; item < kChunk * w; item += kThreads) {
      const int j = item % w;
      const int r = item / w;
      const float* d_row = s_dup + r * Wp;
      float acc = 0.0f;
      for (int ct = mw_cols[2 * j]; ct < mw_cols[2 * j + 1]; ++ct) {
        const int k = j - mw_band[2 * ct];
        if (k < 0 || k >= mw_band[2 * ct + 1] - mw_band[2 * ct]) continue;
        const float4 b = *reinterpret_cast<const float4*>(s_mw + (k * groups + ct) * kCols);
        const float4 d = *reinterpret_cast<const float4*>(d_row + ct * kCols);
        acc = fmaf(d.x, b.x, acc);
        acc = fmaf(d.y, b.y, acc);
        acc = fmaf(d.z, b.z, acc);
        acc = fmaf(d.w, b.w, acc);
      }
      s_u[r * w + j] = acc;
    }
    __syncthreads();

    // dhm[i][j] += sum over the chunk's rows p of Mh[p][i] * u[p][j], for
    // the rows i that the chunk's row tiles' Mh bands reach. The next
    // chunk's writes of dup and u come after a barrier that every thread
    // reaches only when done here.
    const int pt0 = p0 / kRows;
    const int pt1 = min(pt0 + kTilesPerChunk, n_tiles);
    int i_min = h, i_max = 0;
    for (int t = pt0; t < pt1; ++t) {
      if (mh_band[2 * t + 1] > mh_band[2 * t]) {
        i_min = min(i_min, mh_band[2 * t]);
        i_max = max(i_max, mh_band[2 * t + 1]);
      }
    }
    for (int item = tid; item < max(i_max - i_min, 0) * w; item += kThreads) {
      const int j = item % w;
      const int i = i_min + item / w;
      float acc = s_acc[i * w + j];
      for (int t = pt0; t < pt1; ++t) {
        const int k = i - mh_band[2 * t];
        if (k < 0 || k >= mh_band[2 * t + 1] - mh_band[2 * t]) continue;
        const float4 a = *reinterpret_cast<const float4*>(s_mh + (t * tile_band + k) * kRows);
        const float* u = s_u + (t - pt0) * kRows * w + j;
        acc = fmaf(a.x, u[0], acc);
        acc = fmaf(a.y, u[w], acc);
        acc = fmaf(a.z, u[2 * w], acc);
        acc = fmaf(a.w, u[3 * w], acc);
      }
      s_acc[i * w + j] = acc;
    }
  }
  __syncthreads();

  float* out = grad_maps + static_cast<size_t>(map) * h * w;
  for (int k = tid; k < h * w; k += kThreads) out[k] = s_acc[k];
}

}  // namespace

extern "C" {

// Layout constants; the wrapper checks them against decode.cu's.
int lp_decode_grad_band_rows() { return kRows; }
int lp_decode_grad_band_cols() { return kCols; }
int lp_decode_grad_max_band() { return kMaxBand; }

// Dynamic shared memory one block needs for (h, w) maps upsampled to H rows
// of Wp (padded) columns, with Mh row-tile bands at most `tile_band` wide.
size_t lp_decode_grad_smem_bytes(int h, int w, int H, int Wp, int tile_band) {
  const size_t n_tiles = (static_cast<size_t>(H) + kRows - 1) / kRows;
  return sizeof(float) * (n_tiles * tile_band * kRows + static_cast<size_t>(kMaxBand) * Wp +
                          static_cast<size_t>(h) * Wp + static_cast<size_t>(kChunk) * Wp +
                          static_cast<size_t>(kChunk) * w + static_cast<size_t>(h) * w);
}

// Launches the backward of n_maps maps on `stream` of `device`; returns the
// first CUDA error (cudaGetLastError() after the launch), 0 if none.
int lp_decode_grad_launch(const void* maps, const void* keypoints, const void* lse2, const void* grad_kp,
                          const void* mh_tiles, const void* mw_packed, const void* mh_band,
                          const void* mw_band, const void* mw_cols, void* grad_maps, int n_maps, int h,
                          int w, int H, int W, int Wp, int tile_band, float scale, float temperature,
                          float offset, int device, void* stream) {
  const size_t smem = lp_decode_grad_smem_bytes(h, w, H, Wp, tile_band);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      decode_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_grad_kernel<<<n_maps, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(maps), static_cast<const float*>(keypoints),
      static_cast<const float*>(lse2), static_cast<const float*>(grad_kp),
      static_cast<const float*>(mh_tiles), static_cast<const float*>(mw_packed),
      static_cast<const int*>(mh_band), static_cast<const int*>(mw_band), static_cast<const int*>(mw_cols),
      static_cast<float*>(grad_maps), h, w, H, W, Wp, tile_band, scale, temperature, offset);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
