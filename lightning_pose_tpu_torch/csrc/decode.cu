// Fused soft-argmax decode for Hopper (sm_90a).
//
// Replaces the TPU kernel lightning_pose_tpu/ops/pallas_decode.py
// (run_subpixelmaxima_pallas, body _decode_kernel). Per (frame, keypoint)
// heatmap `hm` of shape (h, w) it computes
//
//   up   = Mh @ hm @ Mw^T          (H, W): bicubic x2 + [1,4,6,4,1] blur, df times
//   p    = softmax(temperature * up) over all H*W pixels
//   x, y = sum(p * col), sum(p * row)
//   conf = sum of p in the (2*window+1)^2 box at (floor(x), floor(y)),
//          clipped to the map, zero outside it
//
// and writes (x - offset, y - offset) and conf. Separate Mh and Mw lift the
// TPU kernel's square-only limit.
//
// What bounds it on the H100: fp32 FMAs and the softmax's exp, not memory:
// each map is 16 KB of input. Densely, the product shape (64x64 maps,
// H = W = 256) costs 64*256*64 + 256*256*64 = 5.2 M FMAs a map. The FMAs
// stay fp32 (no TF32 tensor cores): the softmax multiplies upsample error by
// the temperature (1000) in the logits.
//
// What the design does about it:
// - The TPU kernel keeps the whole (H, W) upsampled map in VMEM. At 256x256
//   fp32 that is 256 KB, more than a block's 227 KB of shared memory. Here a
//   block stages only hm (h*w) and T = hm @ Mw^T (h*W) in shared memory (80 KB
//   at the product shape, so two blocks fit on an SM) and streams the rows of
//   up = Mh @ T through an online softmax that keeps (max, sum, sum*x, sum*y)
//   per thread; the map itself is never stored.
// - Mh and Mw are banded (bicubic taps plus blur: at most 9 non-zeros a
//   row at df 2). The wrapper passes, per tile of 4 rows, the [lo, hi)
//   range of columns where the tile is non-zero, and the sums run over that
//   range only: 0.7 M FMAs a map instead of 5.2 M, and bitwise the same
//   sums, since the skipped terms are exact zeros.
// - Each thread computes a 4x4 tile, so one Mh value (warp-uniform, read
//   through the read-only cache) and one T value (shared memory, consecutive
//   words across lanes) feed four FMAs each.
// - After the pass, the 25 window values are recomputed from Mh rows and T
//   over the same band in the same FMA order as the pass, so they are
//   bitwise the values the softmax saw.
// Mh and Mw^T (64 KB each) are shared by all maps and stay in L2.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4;  // rows and columns of the register tile

// Online-softmax state over a set of logits z_i at pixels (x_i, y_i):
// m = max z, s = sum exp(z - m), sx = sum exp(z - m) x, sy = sum exp(z - m) y.
struct SoftmaxState {
  float m, s, sx, sy;
};

// Rounded product, never contracted into a later FMA, so that the pass and
// the window recompute see the same logit.
__device__ __forceinline__ float logit(float up, float temperature) {
  return __fmul_rn(up, temperature);
}

__device__ __forceinline__ void push(SoftmaxState& st, float z, float x, float y) {
  if (z > st.m) {
    const float a = expf(st.m - z);  // 0 while st.m is -inf
    st.s = fmaf(st.s, a, 1.0f);
    st.sx = fmaf(st.sx, a, x);
    st.sy = fmaf(st.sy, a, y);
    st.m = z;
  } else {
    const float e = expf(z - st.m);
    st.s += e;
    st.sx = fmaf(e, x, st.sx);
    st.sy = fmaf(e, y, st.sy);
  }
}

__device__ __forceinline__ SoftmaxState merge(SoftmaxState a, SoftmaxState b) {
  if (b.m == -INFINITY) return a;
  if (a.m == -INFINITY) return b;
  const float m = fmaxf(a.m, b.m);
  const float ca = expf(a.m - m);
  const float cb = expf(b.m - m);
  return {m, a.s * ca + b.s * cb, a.sx * ca + b.sx * cb, a.sy * ca + b.sy * cb};
}

__device__ __forceinline__ SoftmaxState warp_merge(SoftmaxState st) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    SoftmaxState o;
    o.m = __shfl_xor_sync(0xffffffffu, st.m, offset);
    o.s = __shfl_xor_sync(0xffffffffu, st.s, offset);
    o.sx = __shfl_xor_sync(0xffffffffu, st.sx, offset);
    o.sy = __shfl_xor_sync(0xffffffffu, st.sy, offset);
    st = merge(st, o);
  }
  return st;
}

// One block per map.
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const float* __restrict__ maps,   // (N, h, w)
    const float* __restrict__ mh,     // (H, h)
    const float* __restrict__ mwt,    // (w, W), Mw transposed
    const int* __restrict__ mh_band,  // (ceil(H/4), 2): [lo, hi) of i for Mh rows 4t..4t+3
    const int* __restrict__ mw_band,  // (ceil(W/4), 2): [lo, hi) of j for Mw rows 4t..4t+3
    float* __restrict__ keypoints,    // (N, 2)
    float* __restrict__ confidences,  // (N,)
    int h, int w, int H, int W, float temperature, int window, float offset) {
  extern __shared__ float smem[];
  float* s_hm = smem;          // (h, w)
  float* s_t = smem + h * w;   // (h, W): T = hm @ Mw^T
  __shared__ SoftmaxState s_warp[kWarps];
  __shared__ float s_window[32];

  const int tid = threadIdx.x;
  const float* hm = maps + static_cast<size_t>(blockIdx.x) * h * w;
  for (int i = tid; i < h * w; i += kThreads) s_hm[i] = hm[i];
  __syncthreads();

  const int groups = (W + kTile - 1) / kTile;

  // T[i][q] = sum_j hm[i][j] * MwT[j][q]. A thread's tile is rows i0..i0+3
  // and the 4 adjacent columns q0..q0+3, whose Mw rows share one band of j;
  // lanes hold adjacent column tiles, so their hm reads are adjacent words.
  const int t_row_tiles = (h + kTile - 1) / kTile;
  for (int item = tid; item < groups * t_row_tiles; item += kThreads) {
    const int ct = item % groups;
    const int q0 = ct * kTile;
    const int i0 = (item / groups) * kTile;
    const int j_hi = mw_band[2 * ct + 1];
    float acc[kTile][kTile] = {};
    for (int j = mw_band[2 * ct]; j < j_hi; ++j) {
      float a[kTile], b[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) a[r] = s_hm[min(i0 + r, h - 1) * w + j];
#pragma unroll
      for (int c = 0; c < kTile; ++c) b[c] = __ldg(mwt + j * W + min(q0 + c, W - 1));
#pragma unroll
      for (int r = 0; r < kTile; ++r)
#pragma unroll
        for (int c = 0; c < kTile; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int c = 0; c < kTile; ++c)
        if (i0 + r < h && q0 + c < W) s_t[(i0 + r) * W + q0 + c] = acc[r][c];
  }
  __syncthreads();

  // up = Mh @ T, streamed through the online softmax. A thread's tile is
  // rows p0..p0+3 (one band of i) and the columns cg + c * groups (c = 0..3):
  // lanes hold consecutive cg, so their T reads are consecutive words, and a
  // warp shares its rows.
  SoftmaxState st = {-INFINITY, 0.0f, 0.0f, 0.0f};
  const int up_row_tiles = (H + kTile - 1) / kTile;
  for (int item = tid; item < groups * up_row_tiles; item += kThreads) {
    const int cg = item % groups;
    const int pt = item / groups;
    const int p0 = pt * kTile;
    const int i_hi = mh_band[2 * pt + 1];
    float acc[kTile][kTile] = {};
    for (int i = mh_band[2 * pt]; i < i_hi; ++i) {
      float a[kTile], b[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) a[r] = __ldg(mh + min(p0 + r, H - 1) * h + i);
#pragma unroll
      for (int c = 0; c < kTile; ++c) b[c] = s_t[i * W + min(cg + c * groups, W - 1)];
#pragma unroll
      for (int r = 0; r < kTile; ++r)
#pragma unroll
        for (int c = 0; c < kTile; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        const int q = cg + c * groups;
        if (p0 + r < H && q < W)
          push(st, logit(acc[r][c], temperature), static_cast<float>(q),
               static_cast<float>(p0 + r));
      }
  }

  // Block-wide merge; every thread ends with the map's totals.
  st = warp_merge(st);
  if ((tid & 31) == 0) s_warp[tid >> 5] = st;
  __syncthreads();
  st = s_warp[0];
#pragma unroll
  for (int k = 1; k < kWarps; ++k) st = merge(st, s_warp[k]);
  const float px = st.sx / st.s;
  const float py = st.sy / st.s;

  // Confidence: softmax mass in the window at the floored, clipped location.
  const int side = 2 * window + 1;  // the wrapper keeps side * side <= 32
  if (tid < 32) {
    const int xi = min(max(static_cast<int>(floorf(px)), 0), W - 1);
    const int yi = min(max(static_cast<int>(floorf(py)), 0), H - 1);
    float e = 0.0f;
    if (tid < side * side) {
      const int p = yi + tid / side - window;
      const int q = xi + tid % side - window;
      if (p >= 0 && p < H && q >= 0 && q < W) {
        const int pt = p / kTile;  // same band and FMA order as the pass above
        float acc = 0.0f;
        for (int i = mh_band[2 * pt]; i < mh_band[2 * pt + 1]; ++i)
          acc = fmaf(__ldg(mh + p * h + i), s_t[i * W + q], acc);
        e = expf(logit(acc, temperature) - st.m);
      }
    }
    s_window[tid] = e;
    __syncwarp();
    if (tid == 0) {
      float mass = 0.0f;
      for (int k = 0; k < side * side; ++k) mass += s_window[k];
      keypoints[2 * blockIdx.x] = px - offset;
      keypoints[2 * blockIdx.x + 1] = py - offset;
      confidences[blockIdx.x] = mass / st.s;
    }
  }
}

}  // namespace

extern "C" {

// Rows per tile of the [lo, hi) bands the launch takes.
int lp_decode_band_rows() { return kTile; }

// Shared memory one block needs for (h, w) maps upsampled to width W.
size_t lp_decode_smem_bytes(int h, int w, int W) {
  return sizeof(float) * (static_cast<size_t>(h) * w + static_cast<size_t>(h) * W);
}

// Launches the decode of n_maps maps on `stream` of `device`; returns the
// first CUDA error (cudaGetLastError() after the launch), 0 if none.
int lp_decode_launch(const void* maps, const void* mh, const void* mwt, const void* mh_band,
                     const void* mw_band, void* keypoints, void* confidences,
                     int n_maps, int h, int w, int H, int W,
                     float temperature, int window, float offset, int device,
                     void* stream) {
  const size_t smem = lp_decode_smem_bytes(h, w, W);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_kernel<<<n_maps, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(maps), static_cast<const float*>(mh),
      static_cast<const float*>(mwt), static_cast<const int*>(mh_band),
      static_cast<const int*>(mw_band), static_cast<float*>(keypoints),
      static_cast<float*>(confidences), h, w, H, W, temperature, window, offset);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
