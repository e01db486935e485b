"""Where the decode kernel's time goes, on one CUDA card (a development
bench of the PyTorch port, not part of it).

Run from the root of a checkout:  python3 scripts/torch_decode_phases.py

Builds ``lightning_pose_tpu_torch/csrc/decode.cu`` twice with the flags of
``ops/cuda_build.py``: as it is, and with a ``clock64()`` stamp per block
after each phase (staging, T = hm @ Mw^T, up = Mh @ T with the softmax,
the cluster merge, the window). Times both at the product shape (96 x 17
maps of 64 x 64, df 2, softmaxed random logits; CUDA events over 100
back-to-back launches), checks both against the plain decode, then prints
each phase's cycles (mean, median, p90 over blocks), the blocks' lifetime
and how many blocks shared an SM. ``-Xptxas -v`` gives the registers.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

PHASES = ["staging", "T", "up + softmax", "merge + cluster barrier", "window"]


def stamped(src: str) -> str:
    """``src`` with a clock64() stamp per block after each phase, an SM id,
    and an ``extern "C"`` getter of the stamps."""

    def stamp(k: int) -> str:
        return f"  if (threadIdx.x == 0) g_stamps[blockIdx.x * 8 + {k}] = clock64();\n"

    src = src.replace("namespace {\n\nconstexpr", "__device__ long long g_stamps[1 << 20];\nnamespace {\n\nconstexpr", 1)
    head = "  const float* hm = maps +"
    smid = '  if (threadIdx.x == 0) { unsigned sm; asm("mov.u32 %0, %%smid;" : "=r"(sm)); g_stamps[blockIdx.x * 8 + 7] = sm; }\n'
    src = src.replace(head, smid + stamp(0) + head, 1)
    out, n = [], 0
    for line in src.split("\n"):
        out.append(line)
        if line == "  __syncthreads();" and n < 3:
            n += 1
            out.append(stamp(n).rstrip("\n"))
    src = "\n".join(out)
    src = src.replace("  cluster.sync();\n\n  if (tid < 32) {", "  cluster.sync();\n" + stamp(4) + "\n  if (tid < 32) {", 1)
    arrive = '  asm volatile("barrier.cluster.arrive.release;'
    src = src.replace(arrive, stamp(5) + arrive, 1)
    assert src.count("g_stamps[blockIdx.x * 8 +") == 7, "decode.cu changed shape; update the stamps"
    return src + '\nextern "C" int lp_stamps(void* dst, size_t n) { return (int)cudaMemcpyFromSymbol(dst, g_stamps, n); }\n'


def main() -> int:
    import torch

    from lightning_pose_tpu_torch.ops import cuda_build, decode_kernel

    if not torch.cuda.is_available():
        raise SystemExit("torch_decode_phases: needs a CUDA device")
    out_dir = cuda_build.BUILD_DIR.parent / "bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (cuda_build.CSRC_DIR / "decode.cu").read_text()
    libs = {}
    for name, text in (("as_is", source), ("stamped", stamped(source))):
        src, lib = out_dir / f"decode_{name}.cu", out_dir / f"decode_{name}.so"
        src.write_text(text)
        proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(proc.stdout + proc.stderr)
        print(name, "; ".join(re.findall(r"Used \d+ registers[^\n]*", proc.stdout + proc.stderr)))
        libs[name] = lib

    rng = np.random.default_rng(0)
    z = rng.standard_normal((96, 17, 64 * 64)).astype(np.float32) * 3.0
    hm = torch.softmax(torch.from_numpy(z), dim=-1).reshape(96, 17, 64, 64).cuda()
    kp_ref, _ = decode_kernel.decode_plain(hm, 2)

    def use(lib_path: Path) -> ctypes.CDLL:
        decode_kernel.load_library = lambda _name: ctypes.CDLL(str(lib_path))
        decode_kernel._library.cache_clear()
        decode_kernel._device_operands.cache_clear()
        return decode_kernel._library()

    def ms(n: int = 100) -> float:
        for _ in range(5):
            decode_kernel.decode(hm, 2)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            decode_kernel.decode(hm, 2)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for name, lib_path in libs.items():
        lib = use(lib_path)
        kp, _ = decode_kernel.decode(hm, 2)
        err = float((kp - kp_ref).abs().max())
        print(f"{name}: {ms():.4f} ms per launch of 1632 maps, keypoints {err:.2e} px from the plain decode [{smi}]")

    torch.cuda.synchronize()
    decode_kernel.decode(hm, 2)
    torch.cuda.synchronize()
    n_blocks = 96 * 17 * lib.lp_decode_cluster_blocks()
    stamps = np.zeros(n_blocks * 8, dtype=np.int64)
    lib.lp_stamps.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    if lib.lp_stamps(stamps.ctypes.data, stamps.nbytes):
        raise SystemExit("could not read the stamps")
    t = stamps.reshape(n_blocks, 8)
    cycles = np.diff(t[:, :6], axis=1)
    for k, phase in enumerate(PHASES):
        c = cycles[:, k]
        print(f"  {phase}: {c.mean():.0f} cycles mean, {np.median(c):.0f} median, {np.percentile(c, 90):.0f} p90")
    life = t[:, 5] - t[:, 0]
    sm = t[:, 7]
    mid = (t[:, 0] + t[:, 5]) // 2
    shared = [int(((sm == sm[i]) & (t[:, 0] <= mid[i]) & (t[:, 5] >= mid[i])).sum()) for i in range(0, n_blocks, 7)]
    print(f"  block lifetime {life.mean():.0f} cycles mean; blocks sharing an SM at mid-life "
          f"(count: blocks) {dict(enumerate(np.bincount(shared).tolist()))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
