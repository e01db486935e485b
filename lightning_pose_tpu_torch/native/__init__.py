"""Native (C++) host frame ops, built at first use (the port's copy of what
it uses of ``lightning_pose_tpu/native/``).

``frame_ops.cpp`` fuses BGR->RGB conversion with bilinear resize, and a
per-frame bbox crop before it, over a batch of frames, and converts RGB
batches to planar I420 for the yuv420 transfer, on a worker pool. It is compiled with g++ at first use into
``build/native/libframeops-<hash>.so`` at the root of the checkout (the hash
covers the source and the flags, so an edited source is rebuilt). Where g++
is missing or the build fails, :func:`batch_resize_rgb`,
:func:`batch_crop_resize_rgb` and :func:`batch_rgb_to_i420` run the same
operations with OpenCV, one frame at a time.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "available", "batch_crop_resize_rgb", "batch_resize_rgb", "batch_rgb_to_i420", "get_lib", "num_worker_threads",
]

_SRC = Path(__file__).resolve().parent / "frame_ops.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def num_worker_threads() -> int:
    return max(1, (os.cpu_count() or 1) - 1)


def _library_path() -> Path:
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"libframeops-{key}.so"


def _build(out: Path) -> bool:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning(f"native frame-ops build failed ({e}); using the cv2 path")
        return False
    os.replace(tmp, out)
    return True


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, built if needed; None if it cannot be built or
    loaded (the first failure is remembered for the process)."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        out = _library_path()
        if not out.is_file() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            logger.warning(f"could not load native frame-ops ({e}); using the cv2 path")
            return None
        lib.batch_resize_rgb.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.batch_resize_rgb.restype = None
        lib.batch_crop_resize_rgb.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.batch_crop_resize_rgb.restype = None
        lib.batch_rgb_to_i420.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.batch_rgb_to_i420.restype = None
        _lib = lib
        return lib


def available() -> bool:
    """Whether the native library is built and loaded."""
    return get_lib() is not None


def batch_resize_rgb(
    frames: np.ndarray,
    dst_h: int,
    dst_w: int,
    swap_rb: bool = False,
    num_threads: int | None = None,
) -> np.ndarray:
    """Fused (BGR->)RGB conversion + bilinear resize over a frame batch.

    Args:
        frames: (N, H, W, 3) uint8.
    Returns:
        (N, dst_h, dst_w, 3) uint8.
    """
    lib = get_lib()
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    n, src_h, src_w, _ = frames.shape
    out = np.empty((n, dst_h, dst_w, 3), dtype=np.uint8)
    if lib is None:
        import cv2

        for i in range(n):
            f = frames[i]
            if swap_rb:
                f = cv2.cvtColor(f, cv2.COLOR_BGR2RGB)
            out[i] = cv2.resize(f, (dst_w, dst_h), interpolation=cv2.INTER_LINEAR)
        return out
    lib.batch_resize_rgb(
        frames.ctypes.data, n, src_h, src_w,
        out.ctypes.data, dst_h, dst_w,
        1 if swap_rb else 0,
        num_threads or num_worker_threads(),
    )
    return out


def batch_crop_resize_rgb(
    frames: np.ndarray,
    boxes: np.ndarray,
    dst_h: int,
    dst_w: int,
    num_threads: int | None = None,
) -> np.ndarray:
    """Per-frame crop to an ``[x, y, h, w]`` box, zero outside the frame, then
    the fused BGR->RGB conversion + bilinear resize.

    Args:
        frames: (N, H, W, 3) uint8 BGR.
        boxes: (N, 4) integer [x, y, h, w].
    Returns:
        (N, dst_h, dst_w, 3) uint8 RGB.
    """
    lib = get_lib()
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    boxes = np.ascontiguousarray(boxes, dtype=np.int32)
    n, src_h, src_w, _ = frames.shape
    out = np.empty((n, dst_h, dst_w, 3), dtype=np.uint8)
    if lib is None:
        import cv2

        for i in range(n):
            x, y, bh, bw = (int(v) for v in boxes[i])
            crop = np.zeros((bh, bw, 3), dtype=np.uint8)
            x0, y0 = max(x, 0), max(y, 0)
            x1, y1 = min(x + bw, src_w), min(y + bh, src_h)
            if x1 > x0 and y1 > y0:
                crop[y0 - y:y1 - y, x0 - x:x1 - x] = frames[i, y0:y1, x0:x1]
            out[i] = cv2.resize(cv2.cvtColor(crop, cv2.COLOR_BGR2RGB), (dst_w, dst_h))
        return out
    lib.batch_crop_resize_rgb(
        frames.ctypes.data, n, src_h, src_w, boxes.ctypes.data,
        out.ctypes.data, dst_h, dst_w, 1, num_threads or num_worker_threads(),
    )
    return out


def batch_rgb_to_i420(frames: np.ndarray, num_threads: int | None = None) -> np.ndarray:
    """RGB ``(N, H, W, 3)`` uint8 -> planar I420 ``(N, H*3/2, W)`` uint8,
    BT.601 video range with cv2's top-left-of-2x2 chroma subsampling
    (``cv2.COLOR_RGB2YUV_I420``). ``H`` and ``W`` must be even."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    n, h, w, _ = frames.shape
    if h % 2 or w % 2:
        raise ValueError(f"I420 needs even dims, got {h}x{w}")
    lib = get_lib()
    if lib is None:
        import cv2

        return np.stack([cv2.cvtColor(f, cv2.COLOR_RGB2YUV_I420) for f in frames]).reshape(n, h * 3 // 2, w)
    out = np.empty((n, h * 3 // 2, w), dtype=np.uint8)
    lib.batch_rgb_to_i420(frames.ctypes.data, n, h, w, out.ctypes.data, num_threads or num_worker_threads())
    return out
