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
// and writes (x - offset, y - offset) and conf; where the caller asks for
// it, also lse2 = m + log2(s), the base-2 log-sum-exp of the map's logits,
// from which the backward kernel (decode_grad.cu) recomputes p. Separate Mh
// and Mw lift the TPU kernel's square-only limit.
//
// What bounds it on the H100: fp32 FMAs, not memory (each map is 16 KB of
// input at the product shape, 64x64 maps to 256x256). Mh and Mw are banded
// (at most 9 non-zeros a row at df 2), so the sums run over the non-zero
// band only: bitwise the dense sums, since the skipped terms are exact
// zeros. The FMAs stay fp32, never TF32: the softmax multiplies upsample
// error by the temperature (1000). The 65,536 exponentials of a map need the
// special-function units for about three quarters of the FMAs' time.
//
// What the design does about it:
// - A map is split across a cluster of kCluster blocks. Block r owns a strip
//   of output rows and stages, by cp.async issued all at once, only what
//   that strip's Mh band reaches: hm rows [lo, hi), and its row tiles' Mh
//   bands; it computes T = hm[lo:hi] @ Mw^T (51 KB in all at the product
//   shape, 36 of the 64 rows of T), so 3 blocks of 8 warps share an SM.
// - Each block pushes its strip's softmax state (max, sum, sum*x, sum*y)
//   into every block's shared memory (distributed shared memory); after one
//   cluster barrier each merges them in rank order, so all hold the same
//   totals. The window masses are pushed to rank 0, which alone waits at
//   the second barrier. No second kernel, no global atomics.
// - T is computed with a column tile's Mw band held in registers, read once
//   for all the strip's rows from a band-major copy of Mw (lanes read
//   consecutive 16-byte words), in a loop unrolled to the warp's widest band.
// - up = Mh @ T is computed in 4x8 register tiles: per band step one
//   broadcast 16-byte load of Mh and two 16-byte loads of T feed 32 FMAs. A
//   warp shares its row tile, so the band loop is warp-uniform; 4-row bands
//   hold fewer zeros than 8-row ones.
// - The softmax runs per tile: the tile's maximum first, the running state
//   rescaled once, then one FMA and one exp2 per logit with no branch; the
//   logits are in base 2 (temperature * log2 e folded into one scale).
// - The 25 window values are recomputed, by the block that owns each row,
//   from its Mh band and T in the pass's own FMA order, so each upsampled
//   value is bitwise the one the pass saw.
// The packed Mh and Mw bands are shared by all maps and stay in L2.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;     // rows of an up tile = rows of an Mh band
constexpr int kCols = 4;     // columns of a T tile = of an Mw band = of each half of an up tile
constexpr int kMaxBand = 10;  // widest Mw band the kernel takes (10 at df 3)
constexpr int kHmPad = 16;    // zeros after the staged hm rows (>= kMaxBand, 16-byte multiple)
constexpr int kCluster = 2;  // blocks (strips of rows) per map

// Softmax state over base-2 logits z_i at pixels (x_i, y_i):
// m = max z, s = sum 2^(z - m), sx = sum 2^(z - m) x, sy = sum 2^(z - m) y.
struct SoftmaxState {
  float m, s, sx, sy;
};

// Asynchronous copies from global to shared memory (cp.async): a block
// issues all its staging loads at once and waits for them together.
__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A base-2 logit, rounded; the exponentials take fmaf(up, scale, -max).
__device__ __forceinline__ float logit(float up, float scale) { return __fmul_rn(up, scale); }

__device__ __forceinline__ SoftmaxState merge(SoftmaxState a, SoftmaxState b) {
  if (b.m == -INFINITY) return a;
  if (a.m == -INFINITY) return b;
  const float m = fmaxf(a.m, b.m);
  const float ca = exp2_approx(a.m - m);
  const float cb = exp2_approx(b.m - m);
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

struct TRows {
  const float* s_hm;
  float* s_t;
  const float* mw_packed;
  int ct, groups, j_lo, q0, w, Wp, nb, i_first, splits;
};

// T rows i_first, i_first + splits, ... for column tile ct: the tile's Mw
// band (zero-padded to N, the warp's widest band, so that the lanes of a
// warp run the same unrolled loop) is read once into registers. A zero
// weight adds an exact zero: T is bitwise the banded sum.
template <int N>
__device__ __forceinline__ void t_rows(const TRows& a) {
  float4 b[N];
#pragma unroll
  for (int k = 0; k < N; ++k)
    b[k] = __ldg(reinterpret_cast<const float4*>(a.mw_packed) + k * a.groups + a.ct);
  for (int i = a.i_first; i < a.nb; i += a.splits) {
    // past the band the reads run into the next row or the zero pad
    // (kHmPad floats after the last row), all finite, times a zero weight
    const float* row = a.s_hm + i * a.w + a.j_lo;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float v = row[k];
      acc.x = fmaf(v, b[k].x, acc.x);
      acc.y = fmaf(v, b[k].y, acc.y);
      acc.z = fmaf(v, b[k].z, acc.z);
      acc.w = fmaf(v, b[k].w, acc.w);
    }
    *reinterpret_cast<float4*>(a.s_t + i * a.Wp + a.q0) = acc;
  }
}

// One cluster of kCluster blocks per map; block r owns output rows
// [r * strip_rows, (r + 1) * strip_rows).
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads) decode_kernel(
    const float* __restrict__ maps,        // (N, h, w)
    const float* __restrict__ mh_tiles,    // (ceil(H/kRows), tile_band, kRows): for row tile t,
                                           // Mh[kRows*t + r][lo(t) + k] at [t][k][r], zero past
                                           // the tile's band and past H
    const float* __restrict__ mw_packed,   // (kMaxBand, Wp/kCols, kCols): for band step k and
                                           // column tile ct, Mw^T[lo(ct) + k][kCols*ct + c],
                                           // zero past the band and past W
    const int* __restrict__ mh_band,       // (ceil(H/kRows), 2): [lo, hi) of i for Mh rows of a tile
    const int* __restrict__ mw_band,       // (Wp/kCols, 2): [lo, hi) of j for Mw rows of a tile
    const int* __restrict__ strip_band,    // (kCluster, 2): [lo, hi) of i for a strip's Mh rows
    float* __restrict__ keypoints,         // (N, 2)
    float* __restrict__ confidences,       // (N,)
    float* __restrict__ lse2,              // (N,) or null: m + log2(s) of the map's base-2 logits
    int h, int w, int H, int W, int Wp, int strip_rows, int band_rows, int tile_band, float scale,
    int window, float offset) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ SoftmaxState s_warp[kWarps];
  __shared__ SoftmaxState s_strips[kCluster];  // every strip's state, pushed by its block
  __shared__ float s_mass[kCluster];           // rank 0's: every strip's window mass

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int map = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int p_begin = min(rank * strip_rows, H);
  const int p_end = min(p_begin + strip_rows, H);
  const int tiles = (p_end - p_begin + kRows - 1) / kRows;
  const int ilo = strip_band[2 * rank];
  const int nb = tiles ? strip_band[2 * rank + 1] - ilo : 0;

  float* s_mh = smem;                         // (tiles, tile_band, kRows): Mh band of each tile
  float* s_t = s_mh + strip_rows * tile_band;  // (nb, Wp): T rows ilo..ilo+nb
  float* s_hm = s_t + nb * Wp;        // (nb, w) + kHmPad: hm rows ilo..ilo+nb, then zeros
  if (tid < kHmPad) s_hm[nb * w + tid] = 0.0f;

  const float* hm = maps + (static_cast<size_t>(map) * h + ilo) * w;
  if ((w & 3) == 0 && (reinterpret_cast<uintptr_t>(maps) & 15) == 0) {
    for (int k = 4 * tid; k < nb * w; k += 4 * kThreads) copy_async16(s_hm + k, hm + k);
  } else {
    for (int k = tid; k < nb * w; k += kThreads) copy_async4(s_hm + k, hm + k);
  }
  const float* mh_strip = mh_tiles + static_cast<size_t>(p_begin / kRows) * tile_band * kRows;
  for (int k = 4 * tid; k < tiles * tile_band * kRows; k += 4 * kThreads)
    copy_async16(s_mh + k, mh_strip + k);
  copy_async_wait();
  __syncthreads();

  // T[i][q] = sum_j hm[i][j] * MwT[j][q] over the Mw band of q's tile. A
  // thread owns one tile of kCols adjacent columns and every `splits`-th
  // row. Lanes hold adjacent column tiles.
  const int groups = Wp / kCols;
  const int splits = max(1, kThreads / groups);
  for (int item = tid; item < groups * splits; item += kThreads) {
    const int ct = item % groups;
    const int j_lo = mw_band[2 * ct];
    const int n_j = mw_band[2 * ct + 1] - j_lo;
    const int n_warp = (__reduce_max_sync(__activemask(), static_cast<unsigned>(n_j)) + 1) & ~1;
    const TRows args = {s_hm, s_t, mw_packed, ct, groups, j_lo, ct * kCols, w, Wp, nb, item / groups, splits};
    switch (n_warp) {
      case 0: break;
      case 2: t_rows<2>(args); break;
      case 4: t_rows<4>(args); break;
      case 6: t_rows<6>(args); break;
      case 8: t_rows<8>(args); break;
      default: t_rows<10>(args); break;
    }
  }
  __syncthreads();

  // up = Mh @ T over the strip, streamed through the per-tile softmax. A
  // thread's tile is rows p0..p0+3 and the columns q0..q0+3 and
  // half+q0..half+q0+3 (half = Wp / 2): lanes hold adjacent column groups
  // of one row tile, so each of their two 16-byte T loads is conflict-free
  // and their Mh load is a broadcast.
  const int half = Wp / 2;
  const int halves = half / kCols;
  SoftmaxState st = {-INFINITY, 0.0f, 0.0f, 0.0f};
  for (int item = tid; item < halves * tiles; item += kThreads) {
    const int q0 = (item % halves) * kCols;
    const int tl = item / halves;
    const int p0 = p_begin + tl * kRows;
    const int pt = p0 / kRows;
    const int i_lo = mh_band[2 * pt];
    const int n_i = mh_band[2 * pt + 1] - i_lo;
    const float* band = s_mh + tl * tile_band * kRows;
    const float* t_rows = s_t + (i_lo - ilo) * Wp;
    float acc[kRows][2 * kCols] = {};
    for (int k = 0; k < n_i; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(band + k * kRows);
      const float4 t0 = *reinterpret_cast<const float4*>(t_rows + k * Wp + q0);
      const float4 t1 = *reinterpret_cast<const float4*>(t_rows + k * Wp + half + q0);
      const float av[kRows] = {a.x, a.y, a.z, a.w};
      const float tv[2 * kCols] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < 2 * kCols; ++c) acc[r][c] = fmaf(av[r], tv[c], acc[r][c]);
    }
    // column of acc[.][c]
    auto column = [&](int c) { return c < kCols ? q0 + c : half + q0 + c - kCols; };
    // The tile's largest upsampled value gives its largest logit (the
    // scale is positive); a pixel past the map's edge gets -inf.
    if (p0 + kRows > p_end || half + q0 + kCols > W) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < 2 * kCols; ++c)
          if (p0 + r >= p_end || column(c) >= W) acc[r][c] = -INFINITY;
    }
    float up_max = acc[0][0];  // live: q0 < W and p0 < p_end
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < 2 * kCols; ++c) up_max = fmaxf(up_max, acc[r][c]);
    const float m = fmaxf(st.m, logit(up_max, scale));
    const float rescale = exp2_approx(st.m - m);  // 0 while st.m is -inf
    float col[2 * kCols] = {};
    float ts = 0.0f, ty = 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float row = 0.0f;
#pragma unroll
      for (int c = 0; c < 2 * kCols; ++c) {
        const float e = exp2_approx(fmaf(acc[r][c], scale, -m));
        row += e;
        col[c] += e;
      }
      ts += row;
      ty = fmaf(row, static_cast<float>(p0 + r), ty);
    }
    float tx = 0.0f;
#pragma unroll
    for (int c = 0; c < 2 * kCols; ++c) tx = fmaf(col[c], static_cast<float>(column(c)), tx);
    st.s = fmaf(st.s, rescale, ts);
    st.sx = fmaf(st.sx, rescale, tx);
    st.sy = fmaf(st.sy, rescale, ty);
    st.m = m;
  }

  // The block's state is pushed into every block of the cluster; after one
  // cluster barrier each block merges the strips' states from its own
  // shared memory, in rank order, so that all hold the same totals.
  st = warp_merge(st);
  if ((tid & 31) == 0) s_warp[tid >> 5] = st;
  __syncthreads();
  if (tid < kCluster) {
    SoftmaxState b = s_warp[0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) b = merge(b, s_warp[k]);
    cluster.map_shared_rank(s_strips, tid)[rank] = b;
  }
  cluster.sync();

  if (tid < 32) {
    SoftmaxState tot = s_strips[0];
#pragma unroll
    for (int r = 1; r < kCluster; ++r) tot = merge(tot, s_strips[r]);
    const float px = tot.sx / tot.s;
    const float py = tot.sy / tot.s;

    // Confidence: softmax mass in the window at the floored, clipped
    // location; each block adds the window pixels of its own rows and
    // pushes the sum to rank 0.
    const int side = 2 * window + 1;  // the wrapper keeps side * side <= 32
    const int xi = min(max(static_cast<int>(floorf(px)), 0), W - 1);
    const int yi = min(max(static_cast<int>(floorf(py)), 0), H - 1);
    float e = 0.0f;
    if (tid < side * side) {
      const int p = yi + tid / side - window;
      const int q = xi + tid % side - window;
      if (p >= p_begin && p < p_end && q >= 0 && q < W) {
        const int pt = p / kRows;
        const int i_lo = mh_band[2 * pt];
        const float* band = s_mh + ((p - p_begin) / kRows) * tile_band * kRows + (p - p_begin) % kRows;
        float acc = 0.0f;  // the pass's band and FMA order
        for (int k = 0; k < mh_band[2 * pt + 1] - i_lo; ++k)
          acc = fmaf(band[k * kRows], s_t[(i_lo - ilo + k) * Wp + q], acc);
        e = exp2_approx(fmaf(acc, scale, -tot.m));
      }
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) e += __shfl_down_sync(0xffffffffu, e, offset);
    if (tid == 0) {
      cluster.map_shared_rank(s_mass, 0)[rank] = e;
      if (rank == 0) {
        keypoints[2 * map] = px - offset;
        keypoints[2 * map + 1] = py - offset;
        if (lse2 != nullptr) lse2[map] = tot.m + log2f(tot.s);
        s_warp[0].s = tot.s;
      }
    }
  }
  // Only rank 0 reads what the others push after the first barrier: every
  // thread arrives (release), rank 0 waits (acquire) for the window masses,
  // and the other blocks leave, since no one reads their shared memory now.
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  if (rank == 0) {
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
    if (tid == 0) {
      float mass = 0.0f;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) mass += s_mass[r];
      confidences[map] = mass / s_warp[0].s;
    }
  }
}

}  // namespace

extern "C" {

// Layout constants the wrapper builds its band tables with.
int lp_decode_band_rows() { return kRows; }
int lp_decode_band_cols() { return kCols; }
int lp_decode_cluster_blocks() { return kCluster; }
int lp_decode_max_band() { return kMaxBand; }

// Dynamic shared memory one block needs: T and hm rows of a strip band of
// `band_rows` rows, and the Mh bands (at most `tile_band` wide) of the row
// tiles of `strip_rows` rows.
size_t lp_decode_smem_bytes(int band_rows, int tile_band, int strip_rows, int w, int Wp) {
  const size_t rows = static_cast<size_t>(band_rows);
  return sizeof(float) *
         (rows * Wp + static_cast<size_t>(strip_rows) * tile_band + rows * w + kHmPad);
}

// Launches the decode of n_maps maps on `stream` of `device`; `lse2` may be
// null. Returns the first CUDA error (cudaGetLastError() after the launch),
// 0 if none.
int lp_decode_launch(const void* maps, const void* mh_tiles, const void* mw_packed, const void* mh_band,
                     const void* mw_band, const void* strip_band, void* keypoints,
                     void* confidences, void* lse2, int n_maps, int h, int w, int H, int W, int Wp,
                     int strip_rows, int band_rows, int tile_band, float scale, int window, float offset,
                     int device, void* stream) {
  const size_t smem = lp_decode_smem_bytes(band_rows, tile_band, strip_rows, w, Wp);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_kernel<<<n_maps * kCluster, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(maps), static_cast<const float*>(mh_tiles),
      static_cast<const float*>(mw_packed), static_cast<const int*>(mh_band),
      static_cast<const int*>(mw_band), static_cast<const int*>(strip_band),
      static_cast<float*>(keypoints), static_cast<float*>(confidences), static_cast<float*>(lse2),
      h, w, H, W, Wp,
      strip_rows, band_rows, tile_band, scale, window, offset);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
