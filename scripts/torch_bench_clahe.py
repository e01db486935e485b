"""The PyTorch port's CLAHE blend kernel against the design it replaced, on
one CUDA card (a development bench of the port, not part of it).

Run from the root of a checkout:  python3 scripts/torch_bench_clahe.py [--rounds 7]

At 256 x 256 pixels with a 16 x 16 tile grid, for N = 48 image-channels
(16 images of 3 channels, the table's shape) and N = 6 (2 images, about
what a train step's fired subset holds), with LUTs that the port's
``_clahe_lut_grid`` builds from the pixels, it times:
- ``clahe``: ``csrc/clahe.cu`` through ``clahe_apply`` (bands of half-block
  rows, a ring of 3 tile rows staged by cp.async, 16-byte pixel accesses);
- ``per_row``: the design it replaced, built here from the source below: one
  block per image-channel and half-block row, which stages its two tile rows
  (32 KB) by scalar loads and then blends its pixels one a thread;
- ``copy``: a device copy of as many bytes as the blend moves (pixels in and
  out, LUTs in), half read and half written.
Each is timed one launch at a time with the L2 evicted before each launch by
a read of 512 MiB (as ``chip_smoke.py`` does), 50 launches a round; a first
round is not kept, and the rounds rotate the order. Then, without the flush
(back to back, inputs warm in the L2, as the caller leaves them): both
kernels again. Also printed: every candidate's largest error against
``clahe_apply_plain``; a sweep of launch plans (bands, threads along a row)
with the L2 flushed; ``-Xptxas -v`` of both kernels; cycles per phase from
``clock64()`` stamps of thread 0 of every block (both kernels built again
with stamps); the device time of the whole CLAHE stage at N = 6 (LUT build
against blend) from ``torch.profiler``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FLUSH_BYTES = 512 * 2**20
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM
GRID = 16
SIZE = 256

PER_ROW_SOURCE = r"""
#include <cuda_runtime.h>

#ifdef LP_STAMPS
__device__ long long g_stamps[1 << 20];
#define STAMP(k) if (threadIdx.x == 0) g_stamps[blockIdx.y * 8 * 64 + blockIdx.x * 8 + (k)] = clock64()
#else
#define STAMP(k)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 256;

__device__ __forceinline__ int floor_half(int a) { return a >= 0 ? a / 2 : -1; }

__device__ __forceinline__ float frac(float t) { return t - floorf(t); }

__global__ void __launch_bounds__(kThreads)
clahe_blend_kernel(const float* __restrict__ x, const float* __restrict__ lut,
                   float* __restrict__ out, int H, int W, int g) {
  extern __shared__ float s_lut[];
#ifdef LP_STAMPS
  if (threadIdx.x == 0) {
    unsigned sm;
    asm("mov.u32 %0, %%smid;" : "=r"(sm));
    g_stamps[blockIdx.y * 8 * 64 + blockIdx.x * 8 + 7] = sm;
  }
#endif
  STAMP(0);
  const int r = blockIdx.x;
  const long n = blockIdx.y;
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
  STAMP(1);

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
  STAMP(2);
}

}  // namespace

extern "C" int lp_per_row_launch(const void* x, const void* lut, void* out, int n, int H, int W, int g,
                                 void* stream) {
  const size_t smem = sizeof(float) * 2 * static_cast<size_t>(g) * kBins;
  cudaError_t err = cudaFuncSetAttribute(clahe_blend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  clahe_blend_kernel<<<dim3(2 * g, n), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(lut), static_cast<float*>(out), H, W, g);
  return static_cast<int>(cudaGetLastError());
}

#ifdef LP_STAMPS
extern "C" int lp_stamps(void* dst, size_t n) { return (int)cudaMemcpyFromSymbol(dst, g_stamps, n); }
#endif
"""

# the shipped kernel with thread 0 of each block stamping its start, its end,
# the cycles from its start to the first group's barrier (set-up: the first
# copies and loads issued, the column maps), and per group the cycles it
# waits at the barrier for the block's other warps to end the group before,
# the cycles it waits for the group's tile rows, and the cycles it then
# spends on the group's pixels (x loads it issued before the wait land in
# the last); STAMP_COLS stamps a block
STAMP_COLS = 16
STAMP_EDITS = [
    ("  const int tid = threadIdx.y * blockDim.x + threadIdx.x;\n",
     "  const int tid = threadIdx.y * blockDim.x + threadIdx.x;\n"
     "  long long lp_t0 = clock64(), lp_a = 0, lp_wait = 0, lp_pix = 0, lp_sync = 0, lp_setup = -1;\n"
     "  unsigned long long lp_g0;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(lp_g0));\n"),
    ("    __syncthreads();  // everyone is done with group k-1: its older slot is free\n",
     "    const long long lp_s = clock64();\n"
     "    if (lp_setup < 0) lp_setup = lp_s - lp_t0;\n"
     "    __syncthreads();  // everyone is done with group k-1: its older slot is free\n"
     "    lp_sync += clock64() - lp_s;\n"),
    ("    copy_async_commit();\n    copy_async_wait_prior();\n    __syncthreads();\n",
     "    copy_async_commit();\n    lp_a = clock64();\n    copy_async_wait_prior();\n    __syncthreads();\n"
     "    const long long lp_b = clock64();\n    lp_wait += lp_b - lp_a;\n"),
    ("      if (last) break;\n    }\n  }\n}\n",
     "      if (last) break;\n    }\n    lp_pix += clock64() - lp_b;\n  }\n"
     "  if (tid == 0) {\n    unsigned sm;\n    asm(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
     f"    long long* s = g_stamps + blockIdx.x * {STAMP_COLS};\n"
     "    unsigned long long g1;\n    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g1));\n"
     "    s[0] = lp_t0; s[1] = clock64(); s[2] = lp_wait; s[3] = lp_pix; s[4] = lp_g0; s[5] = g1; s[7] = sm;\n"
     "    s[8] = lp_setup; s[9] = lp_sync;\n"
     "  }\n}\n"),
]


def stamped(src: str) -> str:
    for old, new in STAMP_EDITS:
        assert src.count(old) == 1, "csrc/clahe.cu changed shape; update STAMP_EDITS"
        src = src.replace(old, new)
    src = "__device__ long long g_stamps[1 << 20];\n" + src
    return src + '\nextern "C" int lp_stamps(void* dst, size_t n) { return (int)cudaMemcpyFromSymbol(dst, g_stamps, n); }\n'


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


def warm_ms(fn, iters: int = 200, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build(sources: dict[str, str]) -> dict[str, Path]:
    """Each of ``sources`` (name -> CUDA text) into build/bench/<name>.so, one
    nvcc each, all started together, with the flags of ops/cuda_build.py and
    -Xptxas -v; prints each kernel's registers, spills and shared memory."""
    from lightning_pose_tpu_torch.ops import cuda_build

    out_dir = cuda_build.BUILD_DIR.parent / "bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src, lib = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        src.write_text(text)
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(log)
        for line in log.splitlines():
            if "entry function" in line or "spill" in line or "Used" in line:
                print(f"{name}: {line.strip()}")
        libs[name] = lib
    return libs


# launch plans timed over rotated rounds at each N: (threads_x, bands)
PLAN_CANDIDATES = {
    48: [(32, 4), (64, 11), (64, 8), (32, 5), (16, 2)],
    6: [(32, 32), (64, 32), (32, 16), (32, 11), (16, 16)],
}

# variants of the shipped source, made by replacing lines of it
VARIANTS = {
    "chunk4": [("constexpr int kChunkRows = 2;", "constexpr int kChunkRows = 4;"),
               ("constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 3;")],
}


def variant(src: str, edits) -> str:
    for old, new in edits:
        assert src.count(old) == 1, f"csrc/clahe.cu changed shape; update the variant edit {old!r}"
        src = src.replace(old, new)
    return src


def phase_table(stamps: np.ndarray, cols: dict, life: tuple[int, int], timer: tuple[int, int] | None) -> None:
    """Per block means of each phase (a (start, end) pair of stamp columns or
    one column of summed cycles), the lifetime, how many blocks shared an SM
    at each block's mid-life, and from the global timer (ns) the spread of
    the blocks' starts and the span from the first start to the last end."""
    for name, c in cols.items():
        v = stamps[:, c[1]] - stamps[:, c[0]] if isinstance(c, tuple) else stamps[:, c]
        print(f"    {name}: {v.mean():.0f} cycles mean, {np.median(v):.0f} median, {np.percentile(v, 90):.0f} p90")
    t0, t1 = stamps[:, life[0]], stamps[:, life[1]]
    print(f"    block lifetime {(t1 - t0).mean():.0f} cycles mean, {np.median(t1 - t0):.0f} median")
    sm, mid = stamps[:, 7], (t0 + t1) // 2
    shared = [int(((sm == sm[i]) & (t0 <= mid[i]) & (t1 >= mid[i])).sum()) for i in range(0, len(sm), 3)]
    print(f"    blocks sharing an SM at mid-life (count: blocks) {dict(enumerate(np.bincount(shared).tolist()))}; "
          f"SMs used {len(np.unique(sm))}")
    if timer is not None:
        g0, g1 = stamps[:, timer[0]], stamps[:, timer[1]]
        start = g0 - g0.min()
        print(f"    global timer: span {int(g1.max() - g0.min())} ns from the first start to the last end; "
              f"starts after the first at p50 {np.percentile(start, 50):.0f}, p90 {np.percentile(start, 90):.0f}, "
              f"max {start.max()} ns; block life {np.median(g1 - g0):.0f} ns median")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=7)
    args = parser.parse_args()

    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from lightning_pose_tpu_torch.ops import clahe_kernel, cuda_build
    from lightning_pose_tpu_torch.ops.augment import _clahe_lut_grid, _equalize_clahe_tiled

    if not torch.cuda.is_available():
        raise SystemExit("torch_bench_clahe: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count

    shipped = (cuda_build.CSRC_DIR / "clahe.cu").read_text()
    libs = build({
        "clahe_as_shipped": shipped,
        "clahe_stamped": stamped(shipped),
        **{f"clahe_{name}": variant(shipped, edits) for name, edits in VARIANTS.items()},
        "per_row": PER_ROW_SOURCE,
        "per_row_stamped": "#define LP_STAMPS\n" + PER_ROW_SOURCE,
    })
    cuda_build.build("clahe.cu")
    per_row_lib = ctypes.CDLL(str(libs["per_row"]))
    per_row_stamped = ctypes.CDLL(str(libs["per_row_stamped"]))
    for lib in (per_row_lib, per_row_stamped):
        lib.lp_per_row_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.lp_per_row_launch.restype = ctypes.c_int
    per_row_stamped.lp_stamps.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    load_library = clahe_kernel.load_library

    def use(name: str | None) -> None:
        """Make clahe_kernel launch the library built as ``name`` (None: its own)."""
        clahe_kernel.load_library = load_library if name is None else (lambda _src: ctypes.CDLL(str(libs[name])))
        clahe_kernel._library.cache_clear()

    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(0, 255, (16, 3, SIZE, SIZE)).astype(np.float32)).to(dev)
    clip = torch.from_numpy(rng.uniform(1.0, 8.0, 16).astype(np.float32)).to(dev)
    lut48 = _clahe_lut_grid(images.to(torch.int64), clip, GRID).reshape(48, GRID, GRID, 256).contiguous()
    x48 = images.reshape(48, SIZE, SIZE).contiguous()
    cases = {48: (x48, lut48), 6: (x48[:6].contiguous(), lut48[:6].contiguous())}

    def per_row(x, lut, lib=per_row_lib):
        out = torch.empty_like(x)

        def launch():
            err = lib.lp_per_row_launch(x.data_ptr(), lut.data_ptr(), out.data_ptr(), x.shape[0], SIZE, SIZE,
                                        GRID, stream)
            if err:
                raise RuntimeError(f"per_row launch failed with CUDA error {err}")
            return out

        return launch

    def per_row_wrapped(x, lut):
        """per_row behind the checks and calls of the wrapper it had."""

        def call():
            n, h, w = x.shape
            if x.ndim != 3 or lut.ndim != 4 or tuple(lut.shape) != (n, GRID, GRID, 256):
                raise ValueError("shapes")
            if h % (2 * GRID) or w % (2 * GRID) or x.dtype != torch.float32 or lut.dtype != torch.float32:
                raise ValueError("sizes or types")
            if x.device != lut.device or x.device.type != "cuda" or not (x.is_contiguous() and lut.is_contiguous()):
                raise ValueError("devices or layout")
            if 2 * GRID * 256 * 4 > torch.cuda.get_device_properties(x.device).shared_memory_per_block_optin:
                raise ValueError("shared memory")
            out = torch.empty_like(x)
            err = per_row_lib.lp_per_row_launch(x.data_ptr(), lut.data_ptr(), out.data_ptr(), n, h, w, GRID,
                                                torch.cuda.current_stream(x.device).cuda_stream)
            if err:
                raise RuntimeError(f"per_row launch failed with CUDA error {err}")
            return out

        return call

    def planned(x, lut, plan):
        out = torch.empty_like(x)
        return lambda: clahe_kernel._launch(x, lut, out, plan)

    def device_ms(fn, calls: int = 100) -> float:
        """Mean device time of the kernels ``fn()`` launches, back to back
        (inputs warm in the L2), from torch.profiler."""
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / calls / 1e3

    def host_us(fn, calls: int = 200) -> float:
        """Mean host time of one call of ``fn()`` in us (the enqueue)."""
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / calls * 1e6

    print(f"[{smi}], {sm_count} SMs; L2 flushed before each timed launch unless said otherwise")
    for n, (x, lut) in cases.items():
        ref = clahe_kernel.clahe_apply_plain(x, lut, GRID)
        plan = clahe_kernel.blend_plan(n, SIZE, SIZE, GRID, True, sm_count)
        for name, fn in (("clahe", lambda: clahe_kernel.clahe_apply(x, lut, GRID)), ("per_row", per_row(x, lut))):
            print(f"N={n} {name}: max abs err {float((fn() - ref).abs().max()):.3e} gray against clahe_apply_plain")
        n_bytes = (x.numel() * 2 + lut.numel()) * 4
        bound = n_bytes / HBM_BYTES_PER_S * 1e3
        print(f"N={n}: default plan {plan} ({plan.blocks} blocks, {plan.smem_bytes} B shared memory, "
              f"{plan.blocks_per_sm} blocks an SM by the plan, {clahe_kernel.blocks_per_sm(plan, dev)} by the CUDA "
              f"occupancy calculator); {n_bytes / 1e6:.2f} MB moved, bound {bound:.5f} ms")

        for lib_name in (None, *(f"clahe_{v}" for v in VARIANTS)):
            use(lib_name)
            print(f"N={n} sweep of plans, {lib_name or 'clahe as shipped'} (one round of 50 launches each; every "
                  f"plan within 1e-3 gray of the plain version):")
            for threads_x in (64, 32, 16):
                row = []
                for bands in (1, 2, 3, 4, 6, 8, 11, 16, 22, 32):
                    p = clahe_kernel.make_plan(n, SIZE, SIZE, GRID, 4, threads_x, bands)
                    fn = planned(x, lut, p)
                    err = float((fn() - ref).abs().max())
                    if err > 1e-3:
                        raise SystemExit(f"plan {p}: error {err} against the plain version")
                    row.append(f"{bands}:{flushed_ms(fn):.5f}")
                print(f"  threads_x {threads_x} ({64 // threads_x} column tiles), bands:ms  {'  '.join(row)}")
        use(None)

        print(f"N={n} candidate plans, {args.rounds} rotated rounds of 50 launches (threads_x, bands: median ms, "
              f"min-max):")
        plans = {c: clahe_kernel.make_plan(n, SIZE, SIZE, GRID, 4, *c) for c in PLAN_CANDIDATES[n]}
        fns = {c: planned(x, lut, p) for c, p in plans.items()}
        times: dict = {c: [] for c in plans}
        for r in range(args.rounds):
            order = list(plans)[r % len(plans):] + list(plans)[: r % len(plans)]
            for c in order:
                times[c].append(flushed_ms(fns[c]))
        for c, ms in times.items():
            a = np.asarray(ms)
            print(f"  {c}: {np.median(a):.5f} ({a.min():.5f}-{a.max():.5f}), {plans[c].blocks} blocks"
                  f"{', the default plan' if plans[c] == plan else ''}")

        copy_src = torch.empty(n_bytes // 8, dtype=torch.float32, device=dev)
        copy_dst = torch.empty_like(copy_src)
        candidates = {
            "clahe": lambda x=x, lut=lut: clahe_kernel.clahe_apply(x, lut, GRID),
            "per_row": per_row(x, lut),
            "copy": lambda s=copy_src, d=copy_dst: d.copy_(s),
        }
        names = list(candidates)
        rounds: dict[str, list[float]] = {name: [] for name in names}
        for name in names:  # a first round, not kept: clocks and allocations settle
            flushed_ms(candidates[name])
        for r in range(args.rounds):
            for name in names[r % len(names):] + names[: r % len(names)]:
                rounds[name].append(flushed_ms(candidates[name]))
        print(f"N={n} ({n}, {SIZE}, {SIZE}) g={GRID}: {args.rounds} rotated rounds of 50 launches [{smi}]")
        for name, ms in rounds.items():
            a = np.asarray(ms)
            print(f"  {name}: median {np.median(a):.5f} ms, mean {a.mean():.5f}, min {a.min():.5f}, "
                  f"max {a.max():.5f}, {bound / np.median(a):.1%} of the bound; rounds "
                  f"{' '.join(f'{v:.5f}' for v in a)}")
        warm = [(name, device_ms(candidates[name])) for name in ("clahe", "per_row", "copy", "per_row", "clahe")]
        print(f"  warm (back to back, no flush, device time by torch.profiler over 100 launches, in this order): "
              f"{', '.join(f'{name} {ms:.5f} ms' for name, ms in warm)}")
        hosts = {"clahe_apply": candidates["clahe"], "_launch with the plan made": planned(x, lut, plan),
                 "per_row behind its former wrapper": per_row_wrapped(x, lut),
                 "per_row launcher (ctypes)": candidates["per_row"]}
        print(f"  host time a call (enqueue, 200 calls): "
              f"{', '.join(f'{name} {host_us(fn):.1f} us' for name, fn in hosts.items())}")

    print("phase stamps (thread 0 of each block, clock64 cycles):")
    use("clahe_stamped")
    try:
        for n, (x, lut) in cases.items():
            plan = clahe_kernel.blend_plan(n, SIZE, SIZE, GRID, True, sm_count)
            ref = clahe_kernel.clahe_apply_plain(x, lut, GRID)
            torch.sum(torch.ones(FLUSH_BYTES // 4, device=dev))
            out = clahe_kernel.clahe_apply(x, lut, GRID)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            stamps = np.zeros(plan.blocks * STAMP_COLS, dtype=np.int64)
            if clahe_kernel._library().lp_stamps(ctypes.c_void_p(stamps.ctypes.data), ctypes.c_size_t(stamps.nbytes)):
                raise SystemExit("could not read the stamps")
            print(f"  clahe N={n}, L2 flushed ({plan.blocks} blocks, err {err:.1e}):")
            stamps = stamps.reshape(plan.blocks, STAMP_COLS)
            phase_table(stamps, {"set-up": 8, "at the barrier for the other warps": 9, "waiting for tile rows": 2,
                                 "pixels": 3}, (0, 1), (4, 5))
            rest = stamps[:, 1] - stamps[:, 0] - stamps[:, [2, 3, 8, 9]].sum(axis=1)
            print(f"    the rest (copies issued, loop control): {rest.mean():.0f} cycles mean")

            torch.sum(torch.ones(FLUSH_BYTES // 4, device=dev))
            per_row(x, lut, per_row_stamped)()
            torch.cuda.synchronize()
            stamps = np.zeros(64 * 8 * n, dtype=np.int64)
            if per_row_stamped.lp_stamps(stamps.ctypes.data, stamps.nbytes):
                raise SystemExit("could not read the stamps")
            print(f"  per_row N={n}, L2 flushed ({2 * GRID * n} blocks):")
            phase_table(stamps.reshape(n, 64, 8)[:, : 2 * GRID].reshape(-1, 8),
                        {"staging two tile rows": (0, 1), "pixels": (1, 2)}, (0, 2), None)
    finally:
        use(None)

    # the whole CLAHE stage of a train step's fired subset: LUT build and blend
    imgs = images[:2].permute(0, 2, 3, 1).contiguous()  # (2, H, W, 3): N = 6 image-channels
    calls = 20
    for _ in range(3):
        _equalize_clahe_tiled(imgs, clip[:2], GRID)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            _equalize_clahe_tiled(imgs, clip[:2], GRID)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / calls / 1e3
    blend = sum(e.self_device_time_total for e in kernels if "clahe_blend" in e.key) / calls / 1e3
    print(f"CLAHE stage at N=6 (_equalize_clahe_tiled on (2, {SIZE}, {SIZE}, 3), g={GRID}, warm, torch.profiler "
          f"over {calls} calls): {total:.5f} ms of device time a call, blend kernel {blend:.5f} ms, the rest "
          f"(LUT build by scatter_add and cumsum, the transposes) {total - blend:.5f} ms in "
          f"{sum(e.count for e in kernels) // calls} kernels a call [{smi}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / calls / 1e3:.5f} ms  {e.key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
