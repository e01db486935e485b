"""Where the decode kernel's and its backward kernel's time goes, on one
CUDA card (a development bench of the PyTorch port, not part of it).

Run from the root of a checkout:  python3 scripts/torch_decode_phases.py

Builds ``lightning_pose_tpu_torch/csrc/decode.cu`` twice with the flags of
``ops/cuda_build.py``: as it is, and with a ``clock64()`` stamp per block
after each phase (staging, T = hm @ Mw^T, up = Mh @ T with the softmax,
the cluster merge, the window). Times both at the product shape (96 x 17
maps of 64 x 64, df 2, softmaxed random logits; CUDA events over 100
back-to-back launches), checks both against the plain decode, then prints
each phase's cycles (mean, median, p90 over blocks), the blocks' lifetime
and how many blocks shared an SM. ``-Xptxas -v`` gives the registers.

Then the same for ``csrc/decode_grad.cu`` at the unlabeled window's shape
(32 x 17 maps, df 2; one chunk a strip there): staging, T, up with p and
dup, u = dup @ Mw, dhm += Mh^T @ u with the partials written and the
cluster barrier, the strips' sum through distributed shared memory; both
builds checked against autograd of the plain decode.
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
GRAD_PHASES = ["staging", "T", "up + p + dup", "u = dup Mw", "dhm + partials + cluster barrier", "strip sum + store"]


def stamped(src: str) -> str:
    """``src`` with a clock64() stamp per block after each phase, an SM id,
    and an ``extern "C"`` getter of the stamps."""
    src = src.replace("namespace {\n\nconstexpr", "__device__ long long g_stamps[1 << 20];\nnamespace {\n\nconstexpr", 1)
    head = "  const float* hm = maps +"
    src = src.replace(head, SMID + stamp(0) + head, 1)
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
    return src + GETTER


GETTER = '\nextern "C" int lp_stamps(void* dst, size_t n) { return (int)cudaMemcpyFromSymbol(dst, g_stamps, n); }\n'
SMID = '  if (threadIdx.x == 0) { unsigned sm; asm("mov.u32 %0, %%smid;" : "=r"(sm)); g_stamps[blockIdx.x * 8 + 7] = sm; }\n'


def stamp(k: int) -> str:
    return f"  if (threadIdx.x == 0) g_stamps[blockIdx.x * 8 + {k}] = clock64();\n"


def stamped_grad(src: str) -> str:
    """decode_grad.cu with a clock64() stamp per block after each phase (the
    chunk loop's two barriers stamp the last chunk), an SM id, and the
    getter."""
    src = src.replace("namespace {\n\nconstexpr", "__device__ long long g_stamps[1 << 20];\nnamespace {\n\nconstexpr", 1)
    head = "  const float* hm = maps +"
    src = src.replace(head, SMID + stamp(0) + head, 1)
    out, top, loop = [], 0, 0
    for line in src.split("\n"):
        out.append(line)
        if line == "  __syncthreads();" and top < 2:
            top += 1
            out.append(stamp(top).rstrip("\n"))
        elif line == "    __syncthreads();" and loop < 2:
            loop += 1
            out.append("  " + stamp(2 + loop).rstrip("\n"))
    src = "\n".join(out)
    src = src.replace("  cluster.sync();\n\n  // Block r writes", "  cluster.sync();\n" + stamp(5) + "\n  // Block r writes", 1)
    src = src.replace("  // no block leaves while", stamp(6) + "  // no block leaves while", 1)
    assert src.count("g_stamps[blockIdx.x * 8 +") == 8, "decode_grad.cu changed shape; update the stamps"
    return src + GETTER


def build(out_dir: Path, stem: str, variants: dict[str, str]) -> dict[str, Path]:
    from lightning_pose_tpu_torch.ops import cuda_build

    libs = {}
    for name, text in variants.items():
        src, lib = out_dir / f"{stem}_{name}.cu", out_dir / f"{stem}_{name}.so"
        src.write_text(text)
        proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(proc.stdout + proc.stderr)
        print(stem, name, "; ".join(re.findall(r"Used \d+ registers[^\n]*", proc.stdout + proc.stderr)))
        libs[name] = lib
    return libs


def report(lib: ctypes.CDLL, n_blocks: int, phases: list[str]) -> None:
    """Each phase's cycles over blocks, the blocks' lifetime and how many
    blocks shared an SM at a block's mid-life."""
    stamps = np.zeros(n_blocks * 8, dtype=np.int64)
    lib.lp_stamps.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    if lib.lp_stamps(stamps.ctypes.data, stamps.nbytes):
        raise SystemExit("could not read the stamps")
    t = stamps.reshape(n_blocks, 8)
    last = len(phases)
    cycles = np.diff(t[:, : last + 1], axis=1)
    for k, phase in enumerate(phases):
        c = cycles[:, k]
        print(f"  {phase}: {c.mean():.0f} cycles mean, {np.median(c):.0f} median, {np.percentile(c, 90):.0f} p90")
    life = t[:, last] - t[:, 0]
    sm = t[:, 7]
    mid = (t[:, 0] + t[:, last]) // 2
    shared = [int(((sm == sm[i]) & (t[:, 0] <= mid[i]) & (t[:, last] >= mid[i])).sum()) for i in range(0, n_blocks, 7)]
    print(f"  block lifetime {life.mean():.0f} cycles mean; blocks sharing an SM at mid-life "
          f"(count: blocks) {dict(enumerate(np.bincount(shared).tolist()))}")


def main() -> int:
    import torch

    from lightning_pose_tpu_torch.ops import cuda_build, decode_kernel

    if not torch.cuda.is_available():
        raise SystemExit("torch_decode_phases: needs a CUDA device")
    out_dir = cuda_build.BUILD_DIR.parent / "bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (cuda_build.CSRC_DIR / "decode.cu").read_text()
    libs = build(out_dir, "decode", {"as_is": source, "stamped": stamped(source)})
    grad_source = (cuda_build.CSRC_DIR / "decode_grad.cu").read_text()
    grad_libs = build(out_dir, "decode_grad", {"as_is": grad_source, "stamped": stamped_grad(grad_source)})

    rng = np.random.default_rng(0)
    z = rng.standard_normal((96, 17, 64 * 64)).astype(np.float32) * 3.0
    hm = torch.softmax(torch.from_numpy(z), dim=-1).reshape(96, 17, 64, 64).cuda()
    kp_ref, _ = decode_kernel.decode_plain(hm, 2)
    load = decode_kernel.load_library

    def use(forward: Path, backward: Path | None = None) -> tuple[ctypes.CDLL, ctypes.CDLL]:
        paths = {"decode.cu": forward, "decode_grad.cu": backward}
        decode_kernel.load_library = lambda name: ctypes.CDLL(str(paths[name])) if paths.get(name) else load(name)
        for cached in (decode_kernel._library, decode_kernel._device_operands, decode_kernel._grad_library,
                       decode_kernel._device_grad_operands):
            cached.cache_clear()
        return decode_kernel._library(), decode_kernel._grad_library()

    def ms(fn, n: int = 100) -> float:
        for _ in range(5):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for name, lib_path in libs.items():
        lib, _ = use(lib_path)
        kp, _ = decode_kernel.decode(hm, 2)
        err = float((kp - kp_ref).abs().max())
        t = ms(lambda: decode_kernel.decode(hm, 2))
        print(f"{name}: {t:.4f} ms per launch of 1632 maps, keypoints {err:.2e} px from the plain decode [{smi}]")
    torch.cuda.synchronize()
    decode_kernel.decode(hm, 2)
    torch.cuda.synchronize()
    report(lib, 96 * 17 * lib.lp_decode_cluster_blocks(), PHASES)

    # the backward at the unlabeled window's 544 maps, against autograd of the plain decode
    hm = hm[:32].contiguous()
    g = torch.from_numpy(rng.standard_normal((32, 34)).astype(np.float32)).cuda()
    ref_maps = hm.clone().requires_grad_(True)
    kp_plain, _ = decode_kernel.decode_plain(ref_maps, 2)
    (kp_plain * g).sum().backward()
    grad_ref = ref_maps.grad
    scale = float(grad_ref.abs().max())
    for name, lib_path in grad_libs.items():
        _, grad_lib = use(libs["as_is"], lib_path)
        ops = decode_kernel._device_operands(64, 64, 2, decode_kernel._layout(), hm.device)
        lse2 = torch.empty(32 * 17, device=hm.device)
        kp, _ = decode_kernel._launch(hm, ops, 2, 1000.0, lse2)

        def backward():
            return decode_kernel._launch_grad(hm, kp, lse2, g, ops, 2, 1000.0)

        err = float((backward() - grad_ref).abs().max()) / scale
        plan = decode_kernel._device_grad_operands(64, 64, 2, ops.wp, ops.tile_band, hm.device)
        print(f"{name}: backward {ms(backward):.4f} ms per launch of 544 maps, {err:.2e} of the largest entry from "
              f"autograd of the plain decode; {plan.smem} bytes of shared memory a block, chunks of "
              f"{plan.chunk_rows} of {plan.strip_rows} rows [{smi}]")
    torch.cuda.synchronize()
    backward()
    torch.cuda.synchronize()
    report(grad_lib, 32 * 17 * grad_lib.lp_decode_grad_cluster_blocks(), GRAD_PHASES)
    return 0


if __name__ == "__main__":
    sys.exit(main())
