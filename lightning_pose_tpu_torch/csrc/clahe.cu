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
// rows and hw = tw/2 columns. The half-block row r reads the tile rows
// ylo = clamp(floor((r-1)/2), 0, g-1) and yhi = clamp(floor((r-1)/2)+1, 0,
// g-1); likewise xlo, xhi for the half-block column; the weights are
// wy = frac((y + 0.5)/th - 0.5) and wx = frac((c + 0.5)/tw - 0.5). The
// wrapper (ops/clahe_kernel.py: blend_maps) builds these per column (xlo and
// xhi packed in one int, wx) and per row (wy), the maps _static_maps builds
// (pallas_clahe.py:64-78), with cv2's edge behaviour: at the borders the
// clamped corners coincide and the weights are moot. fp32 throughout, as the
// TPU kernel's HIGHEST-precision dots.
//
// What bounds it on the H100: memory traffic. Per pixel it reads 4 bytes and
// writes 4; the LUTs add 4 bytes a pixel at g = 16 (g*g*256 floats for
// H*W = 256*256 pixels), read once if each tile row is staged once. A
// channel's LUTs (256 KB at g = 16) do not fit a block's shared memory, but
// only two tile rows are ever read together. Next come the shared-memory
// gathers: 4 a pixel, at data-dependent bins, which conflict across lanes.
//
// What the design does about it:
// - Half-block rows come in g + 1 groups that read the same pair of tile
//   rows: {0}, {1, 2}, ..., {2g-3, 2g-2}, {2g-1}; group k reads tile rows
//   max(k-1, 0) and min(k, g-1). A block owns one image-channel, one band of
//   consecutive half-block rows (bands are all the same size, so blocks are
//   evenly loaded; a band may start or end inside a group) and one column
//   tile. It walks down its band group by group with a ring of 3 tile rows
//   in shared memory, holding only the tile columns its columns read: two
//   in use, the next in flight by cp.async (16-byte when the LUTs are
//   16-byte aligned, else 4-byte). So a tile row is staged once per band,
//   not once per half-block row, and arrives while the previous group is
//   blended. The wrapper picks bands and column tiles from (N, H, W, g) and
//   the SM count (ops/clahe_kernel.py: blend_plan).
// - A thread owns VEC consecutive columns of its column tile for the whole
//   block: VEC = 4 where hw is a multiple of 4 and x and out are 16-byte
//   aligned (16-byte loads and stores; the 4 columns lie in one half-block
//   column, so they share xlo and xhi), else 1 (scalar loads and stores).
//   Its column maps are read once into registers; wy once per row; pixel
//   addresses come from loop counters. It loads kChunkRows rows at a time,
//   and the next chunk (of this group or the next) is in flight while it
//   blends the current one. The launch bounds hold it to 64 registers, so an
//   SM holds 4 blocks of 256 threads.
// - Tile columns of a block are read at data-dependent bins: the 4 gathers
//   a pixel stay 4-byte shared-memory loads (the two tile rows as float2
//   would halve the loads but stage each row twice).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 256;
constexpr int kRing = 3;       // tile-row slots in shared memory
constexpr int kChunkRows = 2;  // rows of a thread loaded together
// blocks an SM holds by registers: at most 64 a thread (ops/clahe_kernel.py:
// BLOCKS_PER_SM_BY_REGISTERS)
constexpr int kMinBlocks = 4;

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// waits for every committed group of copies but the newest
__device__ __forceinline__ void copy_async_wait_prior() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// the VEC pixels at p (16-byte aligned when VEC is 4)
template <int VEC>
__device__ __forceinline__ void load_pixels(const float* p, float v[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_pixels(float* p, const float v[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

__device__ __forceinline__ int floor_half(int a) { return a >= 0 ? a / 2 : -1; }  // floor(a / 2), a >= -1

// Block (column tile ct, band, image-channel n) with blockIdx.x =
// (n * bands + band) * col_tiles + ct; blockDim = (threads_x, 256 /
// threads_x); a column tile is threads_x * VEC columns.
template <int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
clahe_blend_kernel(const float* __restrict__ x, const float* __restrict__ lut,
                   const int* __restrict__ xmap, const float* __restrict__ wx_map,
                   const float* __restrict__ wy_map, float* __restrict__ out, int H, int W, int g,
                   int bands, int col_tiles, int tile_cols, bool lut16) {
  extern __shared__ __align__(16) float s_rows[];  // [kRing][tile_cols][kBins]
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int ct = blockIdx.x % col_tiles;
  const int rest = blockIdx.x / col_tiles;
  const int band = rest % bands;
  const long long n = rest / bands;
  const int hh = H / (2 * g);
  // the band's half-block rows [r0, r1), its rows [y_first, y_last) and the
  // groups they fall in, [k0, k1)
  const int r0 = band * 2 * g / bands, r1 = (band + 1) * 2 * g / bands;
  const int y_first = r0 * hh, y_last = r1 * hh;
  const int k0 = (r0 + 1) / 2, k1 = r1 / 2 + 1;
  const int hw = W / (2 * g);
  const int rows_step = kChunkRows * blockDim.y;

  // the tile columns this block's columns read, [tc0, tc0 + ntc): from the
  // first column's xlo to the last one's xhi (no load waits on a map)
  const int c_begin = ct * blockDim.x * VEC;
  const int c_end = min(c_begin + static_cast<int>(blockDim.x) * VEC, W);
  const int tc0 = min(max(floor_half(c_begin / hw - 1), 0), g - 1);
  const int ntc = min(floor_half((c_end - 1) / hw - 1) + 1, g - 1) - tc0 + 1;
  const int slot_len = tile_cols * kBins;

  const float* lut_n = lut + n * g * g * kBins;
  auto stage = [&](int t) {  // tile row t, columns [tc0, tc0 + ntc), into its slot
    const float* src = lut_n + (static_cast<long long>(t) * g + tc0) * kBins;
    float* dst = s_rows + (t % kRing) * slot_len;
    const int count = ntc * kBins;
    if (lut16) {
      for (int i = tid * 4; i < count; i += kThreads * 4) copy_async16(dst + i, src + i);
    } else {
      for (int i = tid; i < count; i += kThreads) copy_async4(dst + i, src + i);
    }
  };
  {
    const int lo = max(k0 - 1, 0), hi = min(k0, g - 1);
    stage(lo);
    if (hi != lo) stage(hi);
    copy_async_commit();
  }

  // this thread's columns, their tile-column offsets and weights
  const int c = c_begin + threadIdx.x * VEC;
  const bool active = c < W;
  int xlo = 0, xhi = 0;
  float wx[VEC];
  if (active) {
    const int m = __ldg(xmap + c);
    xlo = ((m & 0xffff) - tc0) * kBins;
    xhi = ((m >> 16) - tc0) * kBins;
    load_pixels<VEC>(wx_map + c, wx);
  }

  // A chunk is kChunkRows of this thread's rows of a group: rows y, y +
  // blockDim.y, ... below the group's end. The next chunk (of this group or
  // the next) is in flight while the current one is blended.
  const float* x_n = x + n * H * W;
  float* out_n = out + n * H * W;
  float nv[kChunkRows][VEC], nwy[kChunkRows];
  auto load_chunk = [&](int y, int y_end) {
#pragma unroll
    for (int i = 0; i < kChunkRows; ++i) {
      const int yi = y + i * blockDim.y;
      if (active && yi < y_end) {
        load_pixels<VEC>(x_n + static_cast<long long>(yi) * W + c, nv[i]);
        nwy[i] = __ldg(wy_map + yi);
      }
    }
  };
  auto group_end = [&](int k) { return min((2 * k + 1) * hh, y_last); };  // within the band
  int ny = y_first + threadIdx.y;  // the chunk in flight
  load_chunk(ny, group_end(k0));

  for (int k = k0; k < k1; ++k) {
    const int lo = max(k - 1, 0), hi = min(k, g - 1);
    __syncthreads();  // everyone is done with group k-1: its older slot is free
    if (k + 1 < k1 && min(k + 1, g - 1) != hi) stage(k + 1);
    copy_async_commit();
    copy_async_wait_prior();
    __syncthreads();

    const int y_end = group_end(k);
    const float* rlo = s_rows + (lo % kRing) * slot_len;
    const float* rhi = s_rows + (hi % kRing) * slot_len;
    while (true) {
      float v[kChunkRows][VEC], wy[kChunkRows];
#pragma unroll
      for (int i = 0; i < kChunkRows; ++i) {
        wy[i] = nwy[i];
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[i][j] = nv[i][j];
      }
      const int y = ny;
      ny += rows_step;
      const bool last = ny >= y_end;
      if (!last) {
        load_chunk(ny, y_end);
      } else if (k + 1 < k1) {
        ny = y_end + threadIdx.y;
        load_chunk(ny, group_end(k + 1));
      }
#pragma unroll
      for (int i = 0; i < kChunkRows; ++i) {
        const int yi = y + i * blockDim.y;
        if (active && yi < y_end) {
          float o[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const int b = static_cast<int>(fminf(fmaxf(v[i][j], 0.0f), 255.0f));
            const float top = (1.0f - wx[j]) * rlo[xlo + b] + wx[j] * rlo[xhi + b];
            const float bot = (1.0f - wx[j]) * rhi[xlo + b] + wx[j] * rhi[xhi + b];
            o[j] = (1.0f - wy[i]) * top + wy[i] * bot;
          }
          store_pixels<VEC>(out_n + static_cast<long long>(yi) * W + c, o);
        }
      }
      if (last) break;
    }
  }
}

size_t smem_bytes(int tile_cols) { return sizeof(float) * kRing * static_cast<size_t>(tile_cols) * kBins; }

// lets the kernel's `VEC` path take `smem` bytes of dynamic shared memory
template <int VEC>
cudaError_t allow_smem(size_t smem) {
  return cudaFuncSetAttribute(clahe_blend_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int VEC>
int blocks_per_sm(int tile_cols, int* blocks) {
  const size_t smem = smem_bytes(tile_cols);
  const cudaError_t err = allow_smem<VEC>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, clahe_blend_kernel<VEC>, kThreads,
                                                                        smem));
}

template <int VEC>
int launch(const float* x, const float* lut, const int* xmap, const float* wx, const float* wy, float* out,
           int blocks, int H, int W, int g, int threads_x, int bands, int col_tiles, int tile_cols, bool lut16,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(tile_cols);
  const cudaError_t err = allow_smem<VEC>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(threads_x, kThreads / threads_x);
  clahe_blend_kernel<VEC><<<blocks, block, smem, stream>>>(x, lut, xmap, wx, wy, out, H, W, g, bands, col_tiles,
                                                           tile_cols, lut16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs to stage `tile_cols` tile columns of a row.
size_t lp_clahe_smem_bytes(int tile_cols) { return smem_bytes(tile_cols); }

// How many blocks of the kernel's `vec` path one SM of `device` holds at
// once with `tile_cols` tile columns staged (the CUDA occupancy
// calculator); returns the first CUDA error, 0 if none.
int lp_clahe_blocks_per_sm(int vec, int tile_cols, int device, int* blocks) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return vec == 4 ? blocks_per_sm<4>(tile_cols, blocks) : blocks_per_sm<1>(tile_cols, blocks);
}

// Launches the blend of n image-channels of (H, W) pixels on `stream` of
// `device` by the plan the wrapper made (ops/clahe_kernel.py: blend_plan):
// `blocks` = n * bands * col_tiles blocks of threads_x * (256 / threads_x)
// threads, each thread on `vec` (4 or 1) consecutive columns. xmap (W,)
// int32 holds xlo | xhi << 16 per column, wx (W,) and wy (H,) fp32 the
// weights. Returns the first CUDA error (cudaGetLastError() after the
// launch), 0 if none. The caller checks the shapes, H % (2g) == 0,
// W % (2g) == 0, the alignment that vec = 4 needs, and the shared memory.
int lp_clahe_launch(const void* x, const void* lut, const void* xmap, const void* wx, const void* wy, void* out,
                    int blocks, int H, int W, int g, int vec, int threads_x, int bands, int col_tiles,
                    int tile_cols, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool lut16 = (reinterpret_cast<uintptr_t>(lut) & 15) == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* lp = static_cast<const float*>(lut);
  const auto* mp = static_cast<const int*>(xmap);
  const auto* wxp = static_cast<const float*>(wx);
  const auto* wyp = static_cast<const float*>(wy);
  auto* op = static_cast<float*>(out);
  if (vec == 4)
    return launch<4>(xp, lp, mp, wxp, wyp, op, blocks, H, W, g, threads_x, bands, col_tiles, tile_cols, lut16, s);
  return launch<1>(xp, lp, mp, wxp, wyp, op, blocks, H, W, g, threads_x, bands, col_tiles, tile_cols, lut16, s);
}

}  // extern "C"
