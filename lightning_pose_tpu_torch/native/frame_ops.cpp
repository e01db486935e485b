// Native host frame ops of the video-ingest pipeline (the port's copy of
// what it uses of lightning_pose_tpu/native/frame_ops.cpp).
//
// The reference offloads video preprocessing to NVIDIA DALI's C++/CUDA
// pipeline (reference lightning_pose/data/dali.py:70-197). Here the host
// stage runs on the CPU cores: BGR->RGB conversion fused with bilinear
// resize, and a per-frame bbox crop before it, over a batch of frames, in a
// dependency-free C++ shared library driven by a std::thread worker pool,
// called through ctypes.
//
// Build (native/__init__.py does it at first use, into build/native/):
//   g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread frame_ops.cpp -o <lib>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Bilinear resize one uint8 HWC image, optionally swapping R/B channels
// (cv2 decodes BGR; models want RGB). Half-pixel centers (align_corners
// false), matching cv2.resize INTER_LINEAR.
void resize_one(const uint8_t* src, int src_h, int src_w,
                uint8_t* dst, int dst_h, int dst_w, bool swap_rb) {
    const float scale_y = static_cast<float>(src_h) / dst_h;
    const float scale_x = static_cast<float>(src_w) / dst_w;
    for (int y = 0; y < dst_h; ++y) {
        float fy = (y + 0.5f) * scale_y - 0.5f;
        fy = std::max(0.0f, std::min(fy, static_cast<float>(src_h - 1)));
        const int y0 = static_cast<int>(fy);
        const int y1 = std::min(y0 + 1, src_h - 1);
        const float wy = fy - y0;
        const uint8_t* row0 = src + static_cast<size_t>(y0) * src_w * 3;
        const uint8_t* row1 = src + static_cast<size_t>(y1) * src_w * 3;
        uint8_t* out_row = dst + static_cast<size_t>(y) * dst_w * 3;
        for (int x = 0; x < dst_w; ++x) {
            float fx = (x + 0.5f) * scale_x - 0.5f;
            fx = std::max(0.0f, std::min(fx, static_cast<float>(src_w - 1)));
            const int x0 = static_cast<int>(fx);
            const int x1 = std::min(x0 + 1, src_w - 1);
            const float wx = fx - x0;
            const float w00 = (1 - wy) * (1 - wx);
            const float w01 = (1 - wy) * wx;
            const float w10 = wy * (1 - wx);
            const float w11 = wy * wx;
            for (int c = 0; c < 3; ++c) {
                const int sc = swap_rb ? 2 - c : c;
                const float v = w00 * row0[x0 * 3 + sc] + w01 * row0[x1 * 3 + sc] +
                                w10 * row1[x0 * 3 + sc] + w11 * row1[x1 * 3 + sc];
                out_row[x * 3 + c] = static_cast<uint8_t>(v + 0.5f);
            }
        }
    }
}

// Run `fn(i)` for i in [0, n) over a worker pool.
template <typename Fn>
void parallel_for(int n, int num_threads, Fn&& fn) {
    if (num_threads <= 1 || n <= 1) {
        for (int i = 0; i < n; ++i) fn(i);
        return;
    }
    std::atomic<int> next{0};
    auto worker = [&]() {
        while (true) {
            const int i = next.fetch_add(1);
            if (i >= n) break;
            fn(i);
        }
    };
    std::vector<std::thread> threads;
    const int k = std::min(num_threads, n);
    threads.reserve(k);
    for (int t = 0; t < k; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Batched fused BGR->RGB + bilinear resize.
// src: (n, src_h, src_w, 3) uint8 contiguous; dst: (n, dst_h, dst_w, 3).
void batch_resize_rgb(const uint8_t* src, int n, int src_h, int src_w,
                      uint8_t* dst, int dst_h, int dst_w,
                      int swap_rb, int num_threads) {
    const size_t src_stride = static_cast<size_t>(src_h) * src_w * 3;
    const size_t dst_stride = static_cast<size_t>(dst_h) * dst_w * 3;
    parallel_for(n, num_threads, [&](int i) {
        resize_one(src + i * src_stride, src_h, src_w,
                   dst + i * dst_stride, dst_h, dst_w, swap_rb != 0);
    });
}

// Batched crop (per-frame bbox) + resize. bboxes: (n, 4) int32 [x, y, h, w];
// regions outside the frame are zero-filled.
void batch_crop_resize_rgb(const uint8_t* src, int n, int src_h, int src_w,
                           const int32_t* bboxes, uint8_t* dst, int dst_h,
                           int dst_w, int swap_rb, int num_threads) {
    const size_t src_stride = static_cast<size_t>(src_h) * src_w * 3;
    const size_t dst_stride = static_cast<size_t>(dst_h) * dst_w * 3;
    parallel_for(n, num_threads, [&](int i) {
        const int32_t bx = bboxes[i * 4 + 0];
        const int32_t by = bboxes[i * 4 + 1];
        const int32_t bh = bboxes[i * 4 + 2];
        const int32_t bw = bboxes[i * 4 + 3];
        // copy the (zero-padded) crop into a temporary buffer, then resize
        std::vector<uint8_t> crop(static_cast<size_t>(bh) * bw * 3, 0);
        const int x0 = std::max(bx, 0);
        const int y0 = std::max(by, 0);
        const int x1 = std::min(bx + bw, src_w);
        const int y1 = std::min(by + bh, src_h);
        const uint8_t* frame = src + i * src_stride;
        for (int y = y0; y < y1; ++y) {
            std::memcpy(crop.data() + (static_cast<size_t>(y - by) * bw + (x0 - bx)) * 3,
                        frame + (static_cast<size_t>(y) * src_w + x0) * 3,
                        static_cast<size_t>(x1 - x0) * 3);
        }
        resize_one(crop.data(), bh, bw, dst + i * dst_stride, dst_h, dst_w,
                   swap_rb != 0);
    });
}

// Batched RGB -> planar I420 (YUV 4:2:0) conversion, BT.601 video range.
// Matches cv2.COLOR_RGB2YUV_I420 semantics: per-pixel Y, chroma taken
// from the top-left pixel of each 2x2 block. src: (n, h, w, 3) uint8,
// h and w even; dst: (n, h*3/2, w) uint8 planar (Y plane, then the
// (h/2, w/2) U plane packed into h/4 rows of width w, then V likewise).
void batch_rgb_to_i420(const uint8_t* src, int n, int h, int w,
                       uint8_t* dst, int num_threads) {
    const size_t src_stride = static_cast<size_t>(h) * w * 3;
    const size_t dst_stride = static_cast<size_t>(h) * w * 3 / 2;
    parallel_for(n, num_threads, [&](int i) {
        const uint8_t* im = src + i * src_stride;
        uint8_t* y_plane = dst + i * dst_stride;
        uint8_t* u_plane = y_plane + static_cast<size_t>(h) * w;
        uint8_t* v_plane = u_plane + static_cast<size_t>(h) * w / 4;
        for (int y = 0; y < h; ++y) {
            const uint8_t* row = im + static_cast<size_t>(y) * w * 3;
            uint8_t* yrow = y_plane + static_cast<size_t>(y) * w;
            for (int x = 0; x < w; ++x) {
                const float r = row[x * 3 + 0];
                const float g = row[x * 3 + 1];
                const float b = row[x * 3 + 2];
                const float yy = 0.256788f * r + 0.504129f * g +
                                 0.097906f * b + 16.0f;
                yrow[x] = static_cast<uint8_t>(
                    std::max(0.0f, std::min(255.0f, yy + 0.5f)));
                if ((y & 1) == 0 && (x & 1) == 0) {
                    const float uu = -0.148223f * r - 0.290993f * g +
                                     0.439216f * b + 128.0f;
                    const float vv = 0.439216f * r - 0.367788f * g -
                                     0.071427f * b + 128.0f;
                    const size_t ci =
                        static_cast<size_t>(y / 2) * (w / 2) + (x / 2);
                    u_plane[ci] = static_cast<uint8_t>(
                        std::max(0.0f, std::min(255.0f, uu + 0.5f)));
                    v_plane[ci] = static_cast<uint8_t>(
                        std::max(0.0f, std::min(255.0f, vv + 0.5f)));
                }
            }
        }
    });
}

}  // extern "C"
