// I420 (planar YUV 4:2:0, uint8) to RGB, for Hopper (sm_90a), with three
// epilogues: ImageNet-normalized bf16, ImageNet-normalized fp32, and raw
// fp32 RGB in [0, 255].
//
// Replaces no TPU kernel: the JAX package converts I420 in plain XLA
// (lightning_pose_tpu/ops/yuv.py:27-62), which the TPU compiler fuses into
// one pass. It computes what the port's plain version computes
// (ops/yuv.py): BT.601 video range, nearest-neighbour chroma, a clamp to
// [0, 255], then for the normalized epilogues one FMA a channel with
// scale = 1 / (255 std) and bias = -mean / std.
//
// What bounds it on the H100: device memory. A pixel reads 1.5 bytes and
// writes 6 (bf16) or 12 (fp32), for about twenty operations. At the bf16
// predict batch ((96, 384, 256) I420 -> (96, 256, 256, 3)) that is 47.2 MB,
// 0.01409 ms at 3.35 TB/s. The first design (Triton, one program a block of
// 256 pixels of a row, a masked (256, 4) output tile) took 0.03307 ms there
// on an H100 80GB HBM3 at 700 W (42.6% of the bound), its bf16 epilogue no
// less than its fp32 one: each of its store instructions wrote 2- or 4-byte
// pieces of many 32-byte sectors. It also loaded each chroma byte in 4
// lanes.
//
// What this design does about it: few, wide memory instructions, each over
// whole 32-byte sectors.
// - A thread owns an 8-column strip of a row pair (2r, 2r+1) of one image:
//   two 8-byte loads for its 16 Y bytes, one 4-byte load each for the
//   strip's 4 U and 4 V bytes. Every input byte is read by one thread,
//   once. Lanes take consecutive strips of one row pair, so a warp covers
//   256 columns and each of its loads is one contiguous run.
// - Each output row of the strip (8 pixels, 24 values) is packed into
//   16-byte words: 3 in bf16 (48 bytes), 6 in fp32 (96 bytes). The warp
//   stages its row (1536 or 3072 contiguous bytes) in shared memory and
//   writes it back lane-contiguously, so that each store instruction is one
//   contiguous 512-byte run of whole 32-byte sectors. Stored straight from
//   registers (the variant compiled with -DLP_I420_STAGED=0), each store
//   instruction writes half of each of 32 sectors at a stride of 48 or 96
//   bytes, and the kernel takes 2.0x (bf16) to 3.2x (fp32) the staged
//   time on an H100 with the L2 flushed: the L2 does not merge those
//   partial sectors for free. scripts/torch_bench_i420.py times both.
// - The chroma products (R from V, G from U and V, B from U) are formed
//   once per chroma sample and shared by its 4 pixels. The sums keep the
//   plain version's order and roundings (__fmul_rn / __fadd_rn, which the
//   compiler does not contract), so the RGB values are the plain version's.
// - The grid runs over (group of 32 strips, group of kWarps row pairs,
//   image): no thread divides by a runtime value, image offsets are size_t,
//   and a launch takes at most 65535 images (the wrapper raises above).
// - The vector path needs W % 8 == 0 and 16-byte-aligned input and output
//   pointers; then the row starts, the U and V planes (H*W and H*W/4 bytes
//   in, with H % 4 == 0) and the chroma rows (W/2) are aligned for those
//   loads and stores. Any other width or pointer runs the scalar path for
//   every strip (byte loads, one store an element, no staging), since a row
//   of a width that is not a multiple of 8 does not start on an 8-byte
//   boundary. It is right and slow (13x the vector path at the bf16
//   predict batch); the product sizes (256 and 384 wide) take the vector
//   path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

// 1: a warp's output rows go through shared memory (the shipped design);
// 0: 16-byte stores straight from registers (scripts/torch_bench_i420.py)
#ifndef LP_I420_STAGED
#define LP_I420_STAGED 1
#endif

namespace {

constexpr int kWarps = 4;  // warps per block, each on its own row pair
constexpr int kStrip = 8;  // columns a thread
// BT.601 video range, as ops/yuv.py has it
constexpr float kYScale = 1.1643836f;
constexpr float kRFromV = 1.5960268f;
constexpr float kGFromU = 0.3917623f;
constexpr float kGFromV = 0.8129676f;
constexpr float kBFromU = 2.0172321f;

enum Epilogue : int { kNormalizedBf16 = 0, kNormalizedFp32 = 1, kRgbFp32 = 2 };

struct Affine {
  float scale[3];
  float bias[3];
};

template <int kEpi>
struct OutOf {
  using type = float;
  static constexpr int kVecs = kStrip * 3 * 4 / 16;  // 16-byte stores a row of a strip
};
template <>
struct OutOf<kNormalizedBf16> {
  using type = __nv_bfloat16;
  static constexpr int kVecs = kStrip * 3 * 2 / 16;
};

__device__ __forceinline__ float byte_of(uint32_t word, int k) {
  return static_cast<float>((word >> (8 * k)) & 0xffu);
}

__device__ __forceinline__ float clamp255(float x) { return fminf(fmaxf(x, 0.0f), 255.0f); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

template <int kEpi, bool kVec, bool kStaged>
__global__ void __launch_bounds__(32 * kWarps) i420_kernel(
    const uint8_t* __restrict__ yuv,  // (N, H*3/2, W)
    void* __restrict__ out_,          // (N, H, W, 3)
    int h, int w, Affine affine) {
  using OutT = typename OutOf<kEpi>::type;
  constexpr int kVecs = OutOf<kEpi>::kVecs;
  OutT* __restrict__ out = static_cast<OutT*>(out_);

  const int lane = threadIdx.x;
  const int pair = blockIdx.y * kWarps + threadIdx.y;
  if (pair >= h / 2) return;  // the whole warp
  const int strips = (w + kStrip - 1) / kStrip;
  const int strip = blockIdx.x * 32 + lane;
  const bool active = strip < strips;
  if (!kStaged && !active) return;  // the staged store needs every lane
  const int c0 = strip * kStrip;
  const int cols = kVec ? kStrip : min(kStrip, w - c0);
  const size_t plane = static_cast<size_t>(h) * w;
  const uint8_t* img = yuv + blockIdx.z * (plane + plane / 2);

  // the strip's 16 Y bytes (two rows) and 4 U and 4 V bytes, as words
  uint32_t yw[2][2] = {{0u, 0u}, {0u, 0u}};
  uint32_t uw = 0u, vw = 0u;
  if (active) {
    const uint8_t* yrow = img + static_cast<size_t>(2 * pair) * w + c0;
    const uint8_t* up = img + plane + static_cast<size_t>(pair) * (w / 2) + c0 / 2;
    const uint8_t* vp = up + plane / 4;
    if constexpr (kVec) {
      const uint2 a = __ldg(reinterpret_cast<const uint2*>(yrow));
      const uint2 b = __ldg(reinterpret_cast<const uint2*>(yrow + w));
      yw[0][0] = a.x;
      yw[0][1] = a.y;
      yw[1][0] = b.x;
      yw[1][1] = b.y;
      uw = __ldg(reinterpret_cast<const unsigned int*>(up));
      vw = __ldg(reinterpret_cast<const unsigned int*>(vp));
    } else {
#pragma unroll
      for (int k = 0; k < kStrip; ++k) {
        if (k < cols) {
          yw[0][k / 4] |= static_cast<uint32_t>(__ldg(yrow + k)) << (8 * (k % 4));
          yw[1][k / 4] |= static_cast<uint32_t>(__ldg(yrow + w + k)) << (8 * (k % 4));
        }
      }
#pragma unroll
      for (int k = 0; k < kStrip / 2; ++k) {
        if (2 * k < cols) {
          uw |= static_cast<uint32_t>(__ldg(up + k)) << (8 * k);
          vw |= static_cast<uint32_t>(__ldg(vp + k)) << (8 * k);
        }
      }
    }
  }

  // the chroma products, once per chroma sample (the plain version forms
  // each product as a tensor of its own, rounded, before the sums)
  float rv[4], gu[4], gv[4], bu[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float u = byte_of(uw, k) - 128.0f;
    const float v = byte_of(vw, k) - 128.0f;
    rv[k] = __fmul_rn(kRFromV, v);
    gu[k] = __fmul_rn(kGFromU, u);
    gv[k] = __fmul_rn(kGFromV, v);
    bu[k] = __fmul_rn(kBFromU, u);
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float val[kStrip * 3];
#pragma unroll
    for (int k = 0; k < kStrip; ++k) {
      const int c = k / 2;
      const float yp = __fmul_rn(kYScale, byte_of(yw[j][k / 4], k % 4) - 16.0f);
      val[3 * k + 0] = clamp255(__fadd_rn(yp, rv[c]));
      val[3 * k + 1] = clamp255(__fsub_rn(__fsub_rn(yp, gu[c]), gv[c]));
      val[3 * k + 2] = clamp255(__fadd_rn(yp, bu[c]));
      if constexpr (kEpi != kRgbFp32) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          val[3 * k + ch] = __fmaf_rn(val[3 * k + ch], affine.scale[ch], affine.bias[ch]);
      }
    }
    OutT* row = out + (static_cast<size_t>(blockIdx.z) * h + 2 * pair + j) * w * 3;

    if constexpr (!kVec) {
#pragma unroll
      for (int k = 0; k < kStrip * 3; ++k) {
        if (k < cols * 3) {
          if constexpr (kEpi == kNormalizedBf16)
            row[c0 * 3 + k] = __float2bfloat16_rn(val[k]);
          else
            row[c0 * 3 + k] = val[k];
        }
      }
    } else {
      uint4 q[kVecs];
      uint32_t* words = reinterpret_cast<uint32_t*>(q);
#pragma unroll
      for (int i = 0; i < kVecs * 4; ++i) {
        if constexpr (kEpi == kNormalizedBf16)
          words[i] = pack_bf16(val[2 * i], val[2 * i + 1]);
        else
          words[i] = __float_as_uint(val[i]);
      }
      if constexpr (!kStaged) {
        uint4* dst = reinterpret_cast<uint4*>(row + static_cast<size_t>(c0) * 3);
#pragma unroll
        for (int i = 0; i < kVecs; ++i) dst[i] = q[i];
      } else {
        // the warp's row (its active strips) in shared memory, then out in
        // lane-consecutive 16-byte words
        __shared__ uint4 stage[kWarps][32 * kVecs];
        uint4* mine = stage[threadIdx.y];
        if (active) {
#pragma unroll
          for (int i = 0; i < kVecs; ++i) mine[lane * kVecs + i] = q[i];
        }
        __syncwarp();
        const int valid = min(32, strips - static_cast<int>(blockIdx.x) * 32) * kVecs;
        uint4* dst = reinterpret_cast<uint4*>(row + static_cast<size_t>(blockIdx.x) * 32 * kStrip * 3);
#pragma unroll
        for (int i = 0; i < kVecs; ++i) {
          const int idx = i * 32 + lane;
          if (idx < valid) dst[idx] = mine[idx];
        }
        __syncwarp();
      }
    }
  }
}

template <int kEpi>
void launch(const uint8_t* yuv, void* out, int n, int h, int w, const Affine& affine, bool vec,
            cudaStream_t stream) {
  const int strips = (w + kStrip - 1) / kStrip;
  const dim3 grid((strips + 31) / 32, (h / 2 + kWarps - 1) / kWarps, n);
  const dim3 block(32, kWarps);
  if (vec)
    i420_kernel<kEpi, true, LP_I420_STAGED != 0><<<grid, block, 0, stream>>>(yuv, out, h, w, affine);
  else
    i420_kernel<kEpi, false, false><<<grid, block, 0, stream>>>(yuv, out, h, w, affine);
}

}  // namespace

extern "C" {

// Converts an (N, H*3/2, W) uint8 I420 batch into (N, H, W, 3) `out` on
// `stream` of `device`. `epilogue`: 0 normalized bf16, 1 normalized fp32
// (out = rgb * s + b per channel), 2 raw fp32 RGB in [0, 255] (s and b
// unused). Needs H % 4 == 0 and an even W. Returns the first CUDA error
// (cudaGetLastError() after the launch), 0 if none.
int lp_i420_launch(const void* yuv, void* out, int n, int h, int w, int epilogue,
                   float s0, float s1, float s2, float b0, float b1, float b2,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (h % 4 != 0 || w % 2 != 0 || n < 0 || epilogue < 0 || epilogue > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Affine affine{{s0, s1, s2}, {b0, b1, b2}};
  const bool vec = w % kStrip == 0 && reinterpret_cast<uintptr_t>(yuv) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto* in = static_cast<const uint8_t*>(yuv);
  const auto s = static_cast<cudaStream_t>(stream);
  if (epilogue == kNormalizedBf16)
    launch<kNormalizedBf16>(in, out, n, h, w, affine, vec, s);
  else if (epilogue == kNormalizedFp32)
    launch<kNormalizedFp32>(in, out, n, h, w, affine, vec, s);
  else
    launch<kRgbFp32>(in, out, n, h, w, affine, vec, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
