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
// of 1000 multiplies any error in up, so up is recomputed bitwise as the
// forward computes it (the same packed bands, the same FMA order). Each map
// is 16 KB in and 16 KB out at the product shape (64x64 maps to 256x256).
//
// What the design does about it:
// - A map is split across a cluster of kCluster blocks, as in decode.cu.
//   Block r owns a strip of output rows; it stages only the hm rows [lo, hi)
//   that its strip's Mh band reaches and builds only those rows of
//   T = hm @ Mw^T (20-24 of 64 at the product shape), with decode.cu's
//   code, so T and up are bitwise the forward's. A block takes 108 KB of
//   shared memory at the product shape, so 2 blocks of 8 warps share an SM.
// - The strip's rows are walked in chunks (one chunk at the product shape):
//   up in decode.cu's 4x8 register tiles, then p and dup, row-major, into
//   shared memory; the bracket of dup is a column term plus a row term,
//   formed once a tile.
// - u = dup @ Mw and dhm += Mh^T @ u are register-tiled banded products over
//   transposed bands that the wrapper packs: for each tile of 4 input
//   columns, the range of output columns its Mw columns reach (aligned to 4,
//   so that dup is read 16 bytes at a time), and for each tile of 4 input
//   rows, the range of output rows its Mh columns reach. The inner loops
//   carry no band test: u does 64 FMAs per 4 shared and 4 cached 16-byte
//   loads, dhm 16 per one of each. In u a thread owns rows l, l+16, l+32,
//   l+48 of one column tile (lanes on rows, conflict-free with the 4-float
//   row pad). In dhm a 4x4 tile of the strip's input rows and columns is
//   kept in registers across the chunks; where the threads suffice (at most
//   kDhmItems * kThreads / 2 tiles a strip), each tile's range of output
//   rows is cut in two halves, held by two threads, so that twice as many
//   warps share the phase.
// - Two barriers a chunk. The strips' partial dhm rows overlap where
//   neighbouring strips' Mh bands do; each block writes its partials into
//   its own shared memory and, after one cluster barrier, sums its share of
//   the output rows from every strip that holds them, in rank order (a
//   strip's two halves first), through distributed shared memory. No
//   atomics: the same result every run.
// The packed bands are shared by all maps and stay in L1/L2. Per-phase
// cycles: scripts/torch_decode_phases.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;      // rows of an Mh row tile (decode.cu's kRows)
constexpr int kCols = 4;      // columns of an Mw column tile (decode.cu's kCols)
constexpr int kMaxBand = 10;  // widest Mw band (decode.cu's kMaxBand)
constexpr int kHmPad = 16;    // zeros after the staged hm rows (decode.cu's kHmPad)
constexpr int kCluster = 4;   // blocks (strips of output rows) per map
constexpr int kRowPad = 4;    // floats after each row of dup and u
constexpr int kULanes = 16;   // a u tile's rows are kULanes apart
constexpr int kUTile = 4;     // rows of a u tile
constexpr int kDhmItems = 2;  // dhm tiles a thread may own

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

__device__ __forceinline__ float component(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

__device__ __forceinline__ void fma4(float a, const float4& b, float* acc) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

struct TRows {
  const float* s_hm;
  float* s_t;
  const float* mw_packed;
  int ct, groups, j_lo, q0, w, Wp, nb, i_first, splits;
};

// decode.cu's t_rows, unchanged: T rows i_first, i_first + splits, ... for
// column tile ct, the tile's Mw band (zero-padded to N) read once into
// registers. A zero weight adds an exact zero: T is bitwise the banded sum.
template <int N>
__device__ __forceinline__ void t_rows(const TRows& a) {
  float4 b[N];
#pragma unroll
  for (int k = 0; k < N; ++k)
    b[k] = __ldg(reinterpret_cast<const float4*>(a.mw_packed) + k * a.groups + a.ct);
  for (int i = a.i_first; i < a.nb; i += a.splits) {
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

// Shared memory of one block, in floats, each region a multiple of 4.
struct Smem {
  int mh, t, u, dup;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Floats of one of a strip's two partial dhm arrays (its rows number at
// most band_rows + 6: from 4 * (lo / 4) past hi, a multiple of 4).
__host__ __device__ inline int part_floats(int w, int band_rows) { return (band_rows + 2 * kRows) * round4(w); }

__host__ __device__ inline Smem smem_layout(int w, int Wp, int strip_rows, int chunk_rows, int band_rows,
                                            int tile_band) {
  const int wu = round4(w);
  Smem s;
  s.mh = strip_rows * tile_band;
  s.t = band_rows * Wp;
  // the staged hm rows until T is built, then u of a chunk
  s.u = round4(imax(band_rows * w + kHmPad, chunk_rows * (wu + kRowPad)));
  // dup of a chunk, then the strip's two partial dhm arrays
  s.dup = imax(chunk_rows * (Wp + kRowPad), 2 * part_floats(w, band_rows));
  return s;
}

// The dhm items of strip `rank` (its 4x4 tiles of input rows and columns),
// and into how many parts each item's range of output rows is cut: 2 where
// the threads hold both halves of every item, else 1. Any block of the
// cluster computes them for any strip.
__device__ __forceinline__ int dhm_items(const int* strip_band, int rank, int n_jt) {
  const int lo = strip_band[2 * rank], hi = strip_band[2 * rank + 1];
  return hi > lo ? ((hi + 3) / 4 - lo / 4) * n_jt : 0;
}

__device__ __forceinline__ int dhm_parts(int n_items) { return 2 * n_items <= kDhmItems * kThreads ? 2 : 1; }

// One cluster of kCluster blocks per map; block r owns output rows
// [r * strip_rows, (r + 1) * strip_rows), walked in chunks of chunk_rows.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 2) decode_grad_kernel(
    const float* __restrict__ maps,        // (N, h, w)
    const float* __restrict__ keypoints,   // (N, 2): x - offset, y - offset
    const float* __restrict__ lse2,        // (N,)
    const float* __restrict__ grad_kp,     // (N, 2): gx, gy
    const float* __restrict__ mh_tiles,    // decode.cu's: (ceil(H/kRows), tile_band, kRows)
    const float* __restrict__ mw_packed,   // decode.cu's: (kMaxBand, Wp/kCols, kCols)
    const int* __restrict__ mh_band,       // (ceil(H/kRows), 2): [lo, hi) of the Mh columns of row tile t
    const int* __restrict__ mw_band,       // (Wp/kCols, 2): [lo, hi) of the Mw columns of column tile ct
    const int* __restrict__ strip_band,    // (kCluster, 2): [lo, hi) of the hm rows strip r reaches
    const float* __restrict__ mwt_packed,  // (ceil(w/4), mwt_width, 4): Mw[lo(jt) + k][4 jt + c] at [jt][k][c]
    const int* __restrict__ mwt_band,      // (ceil(w/4), 2): [lo, hi) of the output columns, multiples of 4
    const float* __restrict__ mht_packed,  // (ceil(h/4), mht_width, 4): Mh[lo(it) + k][4 it + c] at [it][k][c]
    const int* __restrict__ mht_band,      // (ceil(h/4), 2): [lo, hi) of the output rows
    float* __restrict__ grad_maps,         // (N, h, w)
    int h, int w, int H, int W, int Wp, int strip_rows, int chunk_rows, int band_rows, int tile_band,
    int mwt_width, int mht_width, float scale, float temperature, float offset) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int map = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int p_begin = min(rank * strip_rows, H);
  const int p_end = min(p_begin + strip_rows, H);
  const int tiles = (p_end - p_begin + kRows - 1) / kRows;
  const int ilo = strip_band[2 * rank];
  const int nb = tiles ? strip_band[2 * rank + 1] - ilo : 0;
  const int wu = round4(w);
  const int n_jt = wu / 4;
  const int dup_stride = Wp + kRowPad;
  const int u_stride = wu + kRowPad;

  const Smem layout = smem_layout(w, Wp, strip_rows, chunk_rows, band_rows, tile_band);
  float* s_mh = smem;               // (tiles, tile_band, kRows): Mh band of each tile
  float* s_t = s_mh + layout.mh;    // (nb, Wp): T rows ilo..ilo+nb
  float* s_hm = s_t + layout.t;     // (nb, w) + kHmPad zeros, until T is built
  float* s_u = s_hm;                // (chunk_rows, u_stride): u of a chunk
  float* s_dup = s_u + layout.u;    // (chunk_rows, dup_stride): dup of a chunk
  float* s_part = s_dup;            // (rows from 4 it_lo, wu): the strip's partial dhm, at the end

  if (tid < kHmPad) s_hm[nb * w + tid] = 0.0f;
  const float* hm = maps + (static_cast<size_t>(map) * h + ilo) * w;
  if ((w & 3) == 0 && (reinterpret_cast<uintptr_t>(maps) & 15) == 0) {
    for (int k = 4 * tid; k < nb * w; k += 4 * kThreads) copy_async16(s_hm + k, hm + k);
  } else {
    for (int k = tid; k < nb * w; k += kThreads) copy_async4(s_hm + k, hm + k);
  }
  const float* mh_strip = mh_tiles + static_cast<size_t>(p_begin / kRows) * tile_band * kRows;
  for (int k = 4 * tid; k < tiles * tile_band * kRows; k += 4 * kThreads) copy_async16(s_mh + k, mh_strip + k);
  copy_async_wait();
  __syncthreads();

  // T[i][q] = sum_j hm[i][j] * MwT[j][q], as decode.cu computes it
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

  // dup = p * temperature * (gx (c - x) + gy (r - y)), the bracket as a
  // column term plus a row term
  const float tgx = temperature * grad_kp[2 * map];
  const float tgy = temperature * grad_kp[2 * map + 1];
  const float x = keypoints[2 * map] + offset;
  const float y = keypoints[2 * map + 1] + offset;
  const float l2 = lse2[map];
  const int half = Wp / 2;
  const int halves = half / kCols;
  const int it_lo = ilo / 4;
  const int n_items = dhm_items(strip_band, rank, n_jt);  // the wrapper keeps it <= kDhmItems * kThreads
  const int parts = dhm_parts(n_items);
  const int part_size = part_floats(w, band_rows);
  float dacc[kDhmItems][4][4] = {};

  for (int c0 = p_begin; c0 < p_end; c0 += chunk_rows) {
    const int c1 = min(c0 + chunk_rows, p_end);
    const int crows4 = (c1 - c0 + kRows - 1) / kRows * kRows;

    // up over the chunk's rows in decode.cu's 4x8 tiles and FMA order, then
    // dup; pixels past the map's edge get 0
    for (int item = tid; item < halves * (crows4 / kRows); item += kThreads) {
      const int q0 = (item % halves) * kCols;
      const int p0 = c0 + (item / halves) * kRows;
      const int pt = p0 / kRows;
      const int i_lo = mh_band[2 * pt];
      const int n_i = mh_band[2 * pt + 1] - i_lo;
      const float* band = s_mh + ((p0 - p_begin) / kRows) * tile_band * kRows;
      const float* t_rows_p = s_t + (i_lo - ilo) * Wp;
      float acc[kRows][2 * kCols] = {};
      for (int k = 0; k < n_i; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(band + k * kRows);
        const float4 t0 = *reinterpret_cast<const float4*>(t_rows_p + k * Wp + q0);
        const float4 t1 = *reinterpret_cast<const float4*>(t_rows_p + k * Wp + half + q0);
        const float av[kRows] = {a.x, a.y, a.z, a.w};
        const float tv[2 * kCols] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int c = 0; c < 2 * kCols; ++c) acc[r][c] = fmaf(av[r], tv[c], acc[r][c]);
      }
      float cx[2 * kCols];
      bool col_in[2 * kCols];
#pragma unroll
      for (int c = 0; c < 2 * kCols; ++c) {
        const int col = c < kCols ? q0 + c : half + q0 + c - kCols;
        cx[c] = tgx * (static_cast<float>(col) - x);
        col_in[c] = col < W;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool row_in = p0 + r < p_end;
        const float ry = tgy * (static_cast<float>(p0 + r) - y);
        float out[2 * kCols];
#pragma unroll
        for (int c = 0; c < 2 * kCols; ++c) {
          const float p = exp2_approx(fmaf(acc[r][c], scale, -l2));
          out[c] = row_in && col_in[c] ? p * (cx[c] + ry) : 0.0f;
        }
        float* d_row = s_dup + (p0 - c0 + r) * dup_stride;
        *reinterpret_cast<float4*>(d_row + q0) = make_float4(out[0], out[1], out[2], out[3]);
        *reinterpret_cast<float4*>(d_row + half + q0) = make_float4(out[4], out[5], out[6], out[7]);
      }
    }
    __syncthreads();

    // u[r][j] = sum_q dup[r][q] * Mw[q][j] over the output columns that the
    // column tile's Mw columns reach; a thread's rows are kULanes apart
    const int n_lg = kULanes * ((crows4 + kULanes * kUTile - 1) / (kULanes * kUTile));
    for (int item = tid; item < n_jt * n_lg; item += kThreads) {
      const int lg = item % n_lg;
      const int jt = item / n_lg;
      const int rbase = (lg / kULanes) * (kULanes * kUTile) + lg % kULanes;
      if (rbase >= crows4) continue;  // a chunk of fewer than kULanes rows
      const int q_lo = mwt_band[2 * jt];
      const int n_q = mwt_band[2 * jt + 1] - q_lo;
      const float* d_rows[kUTile];
#pragma unroll
      for (int m = 0; m < kUTile; ++m) {
        const int r = rbase + kULanes * m;
        d_rows[m] = s_dup + (r < crows4 ? r : rbase) * dup_stride + q_lo;
      }
      const float4* b_ptr = reinterpret_cast<const float4*>(mwt_packed) + static_cast<size_t>(jt) * mwt_width;
      float acc[kUTile][4] = {};
      for (int k = 0; k < n_q; k += 4) {
        float4 d[kUTile], b[4];
#pragma unroll
        for (int m = 0; m < kUTile; ++m) d[m] = *reinterpret_cast<const float4*>(d_rows[m] + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) b[kk] = __ldg(b_ptr + k + kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int m = 0; m < kUTile; ++m) fma4(component(d[m], kk), b[kk], acc[m]);
      }
#pragma unroll
      for (int m = 0; m < kUTile; ++m) {
        const int r = rbase + kULanes * m;
        if (r < crows4)
          *reinterpret_cast<float4*>(s_u + r * u_stride + 4 * jt) =
              make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      }
    }
    __syncthreads();

    // dhm[i][j] += sum over the chunk's rows p of Mh[p][i] * u[p][j] for the
    // thread's 4x4 tiles of the strip's input rows, over its part of each
    // tile's rows p. The next chunk writes u only after a barrier that every
    // thread reaches when done here.
#pragma unroll
    for (int n = 0; n < kDhmItems; ++n) {
      const int unit = tid + n * kThreads;
      if (unit < parts * n_items) {
        const int item = unit % n_items;
        const int jt = item % n_jt;
        const int it = it_lo + item / n_jt;
        const int band_lo = mht_band[2 * it];
        int p_lo = max(band_lo, c0);
        int p_hi = min(mht_band[2 * it + 1], c1);
        if (parts == 2) {
          const int mid = (p_lo + p_hi) / 2;
          if (unit < n_items) p_hi = mid;
          else p_lo = mid;
        }
        const float4* a_ptr = reinterpret_cast<const float4*>(mht_packed) +
                              static_cast<size_t>(it) * mht_width + (p_lo - band_lo);
        const float* u_ptr = s_u + (p_lo - c0) * u_stride + 4 * jt;
        for (int p = p_lo; p < p_hi; ++p) {
          const float4 a = __ldg(a_ptr++);
          const float4 u = *reinterpret_cast<const float4*>(u_ptr);
          u_ptr += u_stride;
          fma4(a.x, u, dacc[n][0]);
          fma4(a.y, u, dacc[n][1]);
          fma4(a.z, u, dacc[n][2]);
          fma4(a.w, u, dacc[n][3]);
        }
      }
    }
  }

  // The partial dhm rows 4 it_lo .. of each part into the dup region: the
  // last u pass read it before the barrier that ended it.
#pragma unroll
  for (int n = 0; n < kDhmItems; ++n) {
    const int unit = tid + n * kThreads;
    if (unit < parts * n_items) {
      const int item = unit % n_items;
      const int jt = item % n_jt;
      const int it = it_lo + item / n_jt;
      float* part = s_part + (unit / n_items) * part_size;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (4 * it + c < h)
          *reinterpret_cast<float4*>(part + (4 * (it - it_lo) + c) * wu + 4 * jt) =
              make_float4(dacc[n][c][0], dacc[n][c][1], dacc[n][c][2], dacc[n][c][3]);
      }
    }
  }
  cluster.sync();

  // Block r writes output rows [r * ceil(h / kCluster), ...): each the sum,
  // in rank order, of the partials of the strips whose band holds the row,
  // a strip's two parts added first.
  const int rows_per = (h + kCluster - 1) / kCluster;
  const int o_lo = min(rank * rows_per, h);
  const int o_hi = min(o_lo + rows_per, h);
  float* out = grad_maps + static_cast<size_t>(map) * h * w;
  for (int e = tid; e < (o_hi - o_lo) * n_jt; e += kThreads) {
    const int jt = e % n_jt;
    const int i = o_lo + e / n_jt;
    float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const int lo = strip_band[2 * r];
      if (i >= lo && i < strip_band[2 * r + 1]) {
        const float* part = cluster.map_shared_rank(s_part, r) + (i - 4 * (lo / 4)) * wu + 4 * jt;
        float4 v = *reinterpret_cast<const float4*>(part);
        if (dhm_parts(dhm_items(strip_band, r, n_jt)) == 2) {
          const float4 v2 = *reinterpret_cast<const float4*>(part + part_size);
          v = make_float4(v.x + v2.x, v.y + v2.y, v.z + v2.z, v.w + v2.w);
        }
        sum[0] += v.x;
        sum[1] += v.y;
        sum[2] += v.z;
        sum[3] += v.w;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * jt + c < w) out[i * w + 4 * jt + c] = sum[c];
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

}  // namespace

extern "C" {

// Layout constants; the wrapper checks them against its own and decode.cu's.
int lp_decode_grad_band_rows() { return kRows; }
int lp_decode_grad_band_cols() { return kCols; }
int lp_decode_grad_max_band() { return kMaxBand; }
int lp_decode_grad_cluster_blocks() { return kCluster; }
int lp_decode_grad_max_items() { return kDhmItems * kThreads; }

// Dynamic shared memory one block needs for maps w columns wide upsampled to
// Wp (padded) columns, strips of strip_rows output rows walked in chunks of
// chunk_rows, strip bands at most band_rows and Mh tile bands at most
// tile_band wide.
size_t lp_decode_grad_smem_bytes(int w, int Wp, int strip_rows, int chunk_rows, int band_rows, int tile_band) {
  const Smem s = smem_layout(w, Wp, strip_rows, chunk_rows, band_rows, tile_band);
  return sizeof(float) * (static_cast<size_t>(s.mh) + s.t + s.u + s.dup);
}

// Launches the backward of n_maps maps on `stream` of `device`; returns the
// first CUDA error (cudaGetLastError() after the launch), 0 if none.
int lp_decode_grad_launch(const void* maps, const void* keypoints, const void* lse2, const void* grad_kp,
                          const void* mh_tiles, const void* mw_packed, const void* mh_band,
                          const void* mw_band, const void* strip_band, const void* mwt_packed,
                          const void* mwt_band, const void* mht_packed, const void* mht_band, void* grad_maps,
                          int n_maps, int h, int w, int H, int W, int Wp, int strip_rows, int chunk_rows,
                          int band_rows, int tile_band, int mwt_width, int mht_width, float scale,
                          float temperature, float offset, int device, void* stream) {
  const size_t smem = lp_decode_grad_smem_bytes(w, Wp, strip_rows, chunk_rows, band_rows, tile_band);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      decode_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_grad_kernel<<<n_maps * kCluster, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(maps), static_cast<const float*>(keypoints),
      static_cast<const float*>(lse2), static_cast<const float*>(grad_kp),
      static_cast<const float*>(mh_tiles), static_cast<const float*>(mw_packed),
      static_cast<const int*>(mh_band), static_cast<const int*>(mw_band), static_cast<const int*>(strip_band),
      static_cast<const float*>(mwt_packed), static_cast<const int*>(mwt_band),
      static_cast<const float*>(mht_packed), static_cast<const int*>(mht_band),
      static_cast<float*>(grad_maps), h, w, H, W, Wp, strip_rows, chunk_rows, band_rows, tile_band,
      mwt_width, mht_width, scale, temperature, offset);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
