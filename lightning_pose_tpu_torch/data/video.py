"""Host video decode for prediction (the port's copy of what it uses of
``lightning_pose_tpu/data/video.py``, the DALI replacement).

OpenCV's C++/ffmpeg decoder runs on the host with background threads and
feeds fixed-shape uint8 RGB batches; normalization runs on the device.
The batch policy mirrors the reference's DALI predict pipe (reference
dali.py:519-562,699-760): sequential ``sequence_length``-frame windows, the
last one filled by repeating the final frame so that shapes stay static.

A single H.264/H.265 stream decodes serially, so the loader shards the
video by window across ``decode_threads`` worker decoders (each seeks to
its window and decodes one batch; batches are emitted in order). Window
assignment is deterministic, so the batches are the same for any thread
count. Context windows, bbox crops and the yuv420 transfer are not ported
yet.
"""

from __future__ import annotations

import logging
import os
import queue
import threading

import cv2
import numpy as np

from lightning_pose_tpu_torch import native

logger = logging.getLogger(__name__)

__all__ = ["PredictVideoLoader", "VideoFrameDecoder", "count_frames", "default_decode_threads"]

def default_decode_threads() -> int:
    """Worker-decoder count: the LP_TPU_DECODE_THREADS environment variable
    (the JAX package's name), else min(4, cores - 1)."""
    env = os.environ.get("LP_TPU_DECODE_THREADS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            logger.warning(
                "ignoring malformed LP_TPU_DECODE_THREADS=%r "
                "(expected an integer)", env,
            )
    return max(1, min(4, (os.cpu_count() or 1) - 1))


def count_frames(video_file: str) -> int:
    """Number of frames in a video (reference data/utils.py:89)."""
    cap = cv2.VideoCapture(str(video_file))
    try:
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if n > 0:
            return n
        # fall back to an exhaustive scan for containers with bad metadata
        n = 0
        while True:
            ret = cap.grab()
            if not ret:
                break
            n += 1
        return n
    finally:
        cap.release()


class VideoFrameDecoder:
    """Sequential decoder of native-resolution BGR frames (C++/ffmpeg)."""

    def __init__(self, video_file: str):
        self.video_file = str(video_file)
        self.cap = cv2.VideoCapture(self.video_file)
        if not self.cap.isOpened():
            raise FileNotFoundError(f"could not open video {video_file}")
        self.orig_height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.orig_width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))

    def read_raw(self) -> np.ndarray | None:
        """Decode one native-resolution BGR frame (no conversion/resize)."""
        ret, frame = self.cap.read()
        return frame if ret else None

    def seek(self, frame_idx: int) -> None:
        self.cap.set(cv2.CAP_PROP_POS_FRAMES, frame_idx)

    def close(self) -> None:
        self.cap.release()


class PredictVideoLoader:
    """Fixed-shape ``(T, h, w, 3)`` uint8 RGB batches for video inference,
    decoded in background threads while the device computes."""

    def __init__(
        self,
        video_file: str,
        sequence_length: int,
        resize_height: int,
        resize_width: int,
        prefetch_batches: int = 3,
        decode_threads: int | None = None,
    ):
        """``decode_threads``: worker decoders sharding the video by window
        (default :func:`default_decode_threads`)."""
        self.video_file = str(video_file)
        self.seq_len = int(sequence_length)
        self.h = int(resize_height)
        self.w = int(resize_width)
        self.prefetch_batches = prefetch_batches
        # fail fast on bad paths instead of iterating zero batches (the
        # reference's DALI filename validation, reference dali.py:449-455)
        if not os.path.isfile(self.video_file):
            raise FileNotFoundError(
                f"video file does not exist or is not a file: "
                f"{self.video_file}"
            )
        self.frame_count = count_frames(self.video_file)
        if self.frame_count <= 0:
            raise RuntimeError(f"could not decode any frames from {self.video_file}")
        self.decode_threads = (
            decode_threads if decode_threads is not None
            else default_decode_threads()
        )

    def __len__(self) -> int:
        return int(np.ceil(self.frame_count / self.seq_len))

    def _convert(self, raw_frames: list[np.ndarray]) -> np.ndarray:
        """Raw BGR native-resolution frames -> a (T, h, w, 3) RGB uint8 batch
        (the fused native BGR->RGB + resize, parallel across frames)."""
        return native.batch_resize_rgb(np.stack(raw_frames), self.h, self.w, swap_rb=True)

    def _produce(self, q: queue.Queue) -> None:
        decoder = VideoFrameDecoder(self.video_file)
        try:
            # decode raw BGR frames sequentially (the codec is serial), then
            # convert and resize a whole window in one native call
            last_frame = None
            batch = []
            while True:
                frame = decoder.read_raw()
                if frame is None:
                    break
                last_frame = frame
                batch.append(frame)
                if len(batch) == self.seq_len:
                    q.put(self._convert(batch))
                    batch = []
            if batch:
                # FILL policy: repeat the final frame (reference
                # dali.py:699-760)
                while len(batch) < self.seq_len:
                    batch.append(last_frame)
                q.put(self._convert(batch))
        finally:
            decoder.close()
            q.put(None)

    def _decode_window(self, decoder: "VideoFrameDecoder", k: int) -> np.ndarray:
        """Seek-decode window ``k`` ([k*seq_len, (k+1)*seq_len), FILL-padded)."""
        start = k * self.seq_len
        count = min(self.seq_len, max(self.frame_count - start, 0))
        decoder.seek(start)
        raw: list[np.ndarray] = []
        for _ in range(count):
            frame = decoder.read_raw()
            if frame is None:
                break
            raw.append(frame)
        if not raw:  # container metadata overstated frame_count
            decoder.seek(max(self.frame_count - 1, 0))
            frame = decoder.read_raw()
            raw.append(
                frame
                if frame is not None
                else np.zeros(
                    (decoder.orig_height, decoder.orig_width, 3), dtype=np.uint8
                )
            )
        while len(raw) < self.seq_len:
            raw.append(raw[-1])  # FILL policy (reference dali.py:699-760)
        return self._convert(raw)

    def _iter_parallel(self):
        """Window-sharded parallel decode: worker w handles windows
        w, w+K, w+2K, ...; the main thread re-emits them in order. Output
        is identical to the serial path for any thread count."""
        n_batches = len(self)
        n_workers = min(self.decode_threads, n_batches)
        results: dict[int, np.ndarray] = {}
        errors: list[BaseException] = []
        cond = threading.Condition()
        emitted = [0]
        max_pending = n_workers + self.prefetch_batches

        def worker(wid: int) -> None:
            decoder = VideoFrameDecoder(self.video_file)
            try:
                for k in range(wid, n_batches, n_workers):
                    with cond:
                        while (
                            k - emitted[0] >= max_pending and not errors
                        ):
                            cond.wait()
                        if errors:
                            return
                    batch = self._decode_window(decoder, k)
                    with cond:
                        results[k] = batch
                        cond.notify_all()
            except BaseException as e:  # propagate to the consumer
                with cond:
                    errors.append(e)
                    cond.notify_all()
            finally:
                decoder.close()

        threads = [
            threading.Thread(target=worker, args=(w,), daemon=True)
            for w in range(n_workers)
        ]
        for t in threads:
            t.start()
        try:
            for k in range(n_batches):
                with cond:
                    while k not in results and not errors:
                        cond.wait()
                    if errors:
                        raise errors[0]
                    batch = results.pop(k)
                    emitted[0] = k + 1
                    cond.notify_all()
                yield batch
        finally:
            with cond:
                if not errors:
                    errors.append(GeneratorExit("consumer stopped"))
                cond.notify_all()
            for t in threads:
                t.join(timeout=10.0)

    def __iter__(self):
        if self.decode_threads > 1:
            yield from self._iter_parallel()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        t = threading.Thread(target=self._produce, args=(q,), daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            yield item
