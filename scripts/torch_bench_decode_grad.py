"""Launch plans of the decode's backward kernel, on one CUDA card (a
development bench of the PyTorch port, not part of it).

Run from the root of a checkout:  python3 scripts/torch_bench_decode_grad.py

Builds ``lightning_pose_tpu_torch/csrc/decode_grad.cu`` with the flags of
``ops/cuda_build.py`` as it is and in variants made from it by text edits:
strips walked in chunks of 32 rows (69 KB of shared memory a block) at 2
blocks an SM, the same at 3 blocks an SM (``__launch_bounds__(256, 3)``,
which caps the registers at 80), and the u and dhm loops unrolled by the
compiler (``#pragma unroll``). Prints each build's registers and spills
(``-Xptxas -v``), checks each against autograd of the plain decode and
against itself over two launches (bitwise), then times them at the
unlabeled window's shape (32 x 17 maps of 64 x 64, df 2, softmaxed random
logits) in 5 rounds of 100 back-to-back launches whose order alternates,
and prints each one's median round. Cycles per phase of the shipped kernel:
``scripts/torch_decode_phases.py``.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

LOOPS = {
    "u": "      for (int k = 0; k < n_q; k += 4) {",
    "dhm": "        for (int p = p_lo; p < p_hi; ++p) {",
}
TWO_BLOCKS = "__launch_bounds__(kThreads, 2)"


def unrolled(src: str, **factors: int) -> str:
    """``src`` with ``#pragma unroll f`` before the named loops."""
    for name, f in factors.items():
        loop = LOOPS[name]
        assert src.count(loop) == 1, f"decode_grad.cu changed shape; update the {name} loop"
        src = src.replace(loop, loop[: len(loop) - len(loop.lstrip())] + f"#pragma unroll {f}\n" + loop)
    return src


def main() -> int:
    import torch

    from lightning_pose_tpu_torch.ops import cuda_build, decode_kernel

    if not torch.cuda.is_available():
        raise SystemExit("torch_bench_decode_grad: needs a CUDA device")
    source = (cuda_build.CSRC_DIR / "decode_grad.cu").read_text()
    assert source.count(TWO_BLOCKS) == 1, "decode_grad.cu changed shape; update the launch bounds"
    shipped_target = decode_kernel._GRAD_SMEM_TARGET
    chunk32_target = 74 * 1024  # chunks of 32 rows fit, 64 do not
    variants = {  # name: (source, the wrapper's shared-memory target)
        "shipped": (source, shipped_target),
        "chunks of 32, 2 blocks an SM": (source, chunk32_target),
        "chunks of 32, 3 blocks an SM": (source.replace(TWO_BLOCKS, "__launch_bounds__(kThreads, 3)"), chunk32_target),
        "u loop unrolled by 2": (unrolled(source, u=2), shipped_target),
        "dhm loop unrolled by 4": (unrolled(source, dhm=4), shipped_target),
    }
    out_dir = cuda_build.BUILD_DIR.parent / "bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for k, (name, (text, _)) in enumerate(variants.items()):
        src, lib = out_dir / f"decode_grad_v{k}.cu", out_dir / f"decode_grad_v{k}.so"
        src.write_text(text)
        proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(proc.stdout + proc.stderr)
        ptxas = re.findall(r"\d+ bytes spill stores|Used \d+ registers", proc.stdout + proc.stderr)
        print(f"{name}: {'; '.join(ptxas)}")
        libs[name] = lib

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    z = rng.standard_normal((32, 17, 64 * 64)).astype(np.float32) * 3.0
    hm = torch.softmax(torch.from_numpy(z), dim=-1).reshape(32, 17, 64, 64).to(dev)
    g = torch.from_numpy(rng.standard_normal((32, 34)).astype(np.float32)).to(dev)
    ref_maps = hm.clone().requires_grad_(True)
    kp_plain, _ = decode_kernel.decode_plain(ref_maps, 2)
    (kp_plain * g).sum().backward()
    scale = float(ref_maps.grad.abs().max())
    load = decode_kernel.load_library

    def use(name: str):
        lib_path, target = libs[name], variants[name][1]
        decode_kernel.load_library = lambda n: ctypes.CDLL(str(lib_path)) if n == "decode_grad.cu" else load(n)
        decode_kernel._GRAD_SMEM_TARGET = target
        decode_kernel._grad_library.cache_clear()
        decode_kernel._device_grad_operands.cache_clear()
        ops = decode_kernel._device_operands(64, 64, 2, decode_kernel._layout(), dev)
        lse2 = torch.empty(32 * 17, device=dev)
        kp, _ = decode_kernel._launch(hm, ops, 2, 1000.0, lse2)
        plan = decode_kernel._device_grad_operands(64, 64, 2, ops.wp, ops.tile_band, dev)
        return (lambda: decode_kernel._launch_grad(hm, kp, lse2, g, ops, 2, 1000.0)), plan

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
    names = list(variants)
    for name in names:
        fn, plan = use(name)
        first, second = fn(), fn()
        torch.cuda.synchronize()
        err = float((first - ref_maps.grad).abs().max()) / scale
        print(f"{name}: {err:.2e} of the largest entry from autograd of the plain decode, bitwise repeat "
              f"{torch.equal(first, second)}; {plan.smem} bytes of shared memory a block, chunks of {plan.chunk_rows} "
              f"of {plan.strip_rows} rows")
    rounds = {name: [] for name in names}
    for r in range(5):
        for name in names if r % 2 == 0 else names[::-1]:
            fn, _ = use(name)
            rounds[name].append(ms(fn))
    for name, t in rounds.items():
        print(f"{name}: median {np.median(t):.4f} ms per launch of 544 maps, rounds "
              f"{' '.join(f'{v:.4f}' for v in t)} [{smi}]")
    decode_kernel.load_library = load
    return 0


if __name__ == "__main__":
    sys.exit(main())
