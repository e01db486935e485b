"""Host video decode for prediction and for semi-supervised training (the
port's copy of what it uses of ``lightning_pose_tpu/data/video.py``, the
DALI replacement).

OpenCV's C++/ffmpeg decoder runs on the host with background threads and
feeds fixed-shape uint8 RGB batches; normalization and augmentation run on
the device. The batch policies mirror the reference's DALI pipes (reference
dali.py:519-562,699-760):

- predict: sequential ``sequence_length``-frame windows, the last one filled
  by repeating the final frame so that shapes stay static. A single
  H.264/H.265 stream decodes serially, so the loader shards the video by
  window across ``decode_threads`` worker decoders (each seeks to its window
  and decodes one batch; batches are emitted in order). Window assignment
  is deterministic, so the batches are the same for any thread count.
- train (unlabeled): random-start windows of a random video, from a
  counter-keyed generator, decoded by worker threads and emitted in order.

With a per-frame bbox table the predict loader crops each native-resolution
frame to its box before the resize (reference dali.py:332-396). The
multiview loaders read one video a view, frame-synchronized: ``(T, V, h, w,
3)`` batches for prediction, and for training random windows whose sessions
and starts come from the JAX package's own generator sequence.

With ``transfer_format="yuv420"`` the predict loaders and the single-view
unlabeled loader emit planar I420 batches instead, ``(T, h*3/2, w)`` uint8
(``(T, V, h*3/2, w)`` multiview), converted from the RGB batch on the host
by ``native.batch_rgb_to_i420``: half the bytes to copy to the device, where
the I420 kernel (``ops/yuv_kernel.py``) converts them back to RGB.
"""

from __future__ import annotations

import logging
import os
import queue
import threading

import cv2
import numpy as np
import torch

from lightning_pose_tpu_torch import native
from lightning_pose_tpu_torch.utils import tracing

logger = logging.getLogger(__name__)

__all__ = [
    "MultiviewPredictVideoLoader",
    "MultiviewUnlabeledVideoLoader",
    "PredictVideoLoader",
    "UnlabeledVideoLoader",
    "VideoFrameDecoder",
    "count_frames",
    "default_decode_threads",
    "undo_affine_transform_batch",
]


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


def _check_transfer_format(transfer_format: str, height: int, width: int) -> str:
    """``rgb`` or ``yuv420`` (even dims only), as the JAX loaders check."""
    if transfer_format not in ("rgb", "yuv420"):
        raise ValueError(f"unknown transfer_format {transfer_format!r}")
    if transfer_format == "yuv420" and (height % 2 or width % 2):
        raise ValueError("yuv420 transfer requires even resize dims")
    return transfer_format


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
    """Sequential decoder (C++/ffmpeg): native-resolution BGR frames, or RGB
    frames resized on the host to ``(resize_height, resize_width)``."""

    def __init__(self, video_file: str, resize_height: int | None = None, resize_width: int | None = None):
        self.video_file = str(video_file)
        self.h = None if resize_height is None else int(resize_height)
        self.w = None if resize_width is None else int(resize_width)
        self.cap = cv2.VideoCapture(self.video_file)
        if not self.cap.isOpened():
            raise FileNotFoundError(f"could not open video {video_file}")
        self.orig_height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.orig_width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))

    def read_raw(self) -> np.ndarray | None:
        """Decode one native-resolution BGR frame (no conversion/resize)."""
        ret, frame = self.cap.read()
        return frame if ret else None

    def read(self) -> np.ndarray | None:
        """Decode one frame as RGB, resized with ``INTER_LINEAR``."""
        if self.h is None or self.w is None:
            raise ValueError("read() needs the decoder's resize_height and resize_width")
        frame = self.read_raw()
        if frame is None:
            return None
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        return cv2.resize(frame, (self.w, self.h), interpolation=cv2.INTER_LINEAR)

    def seek(self, frame_idx: int) -> None:
        self.cap.set(cv2.CAP_PROP_POS_FRAMES, frame_idx)

    def close(self) -> None:
        self.cap.release()


class PredictVideoLoader:
    """Fixed-shape ``(T, h, w, 3)`` uint8 RGB batches for video inference,
    decoded in background threads while the device computes.

    Batch ``k`` holds frames ``[k*step, k*step + T)``, the frames past the
    end FILL-padded with the last frame. ``step`` is ``T``, or ``T - 4``
    with ``do_context``: a context model's windows overlap by 4 frames, so
    every frame but the first and last two is the center of one window.
    Each window's seek, decode and convert is the span ``lp.loader.decode``
    on the thread that decodes it.
    """

    def __init__(
        self,
        video_file: str,
        sequence_length: int,
        resize_height: int,
        resize_width: int,
        prefetch_batches: int = 3,
        decode_threads: int | None = None,
        bbox_df=None,
        do_context: bool = False,
        transfer_format: str = "rgb",
    ):
        """``decode_threads``: worker decoders sharding the video by window
        (default :func:`default_decode_threads`). ``bbox_df``: optional
        per-frame ``[x, y, h, w]`` DataFrame; each frame is cropped to its
        box (zero outside the frame) before the resize, and the caller maps
        keypoints back through the same boxes. ``do_context``: overlapping
        windows for a context model (``sequence_length`` at least 5).
        ``transfer_format``: ``rgb`` emits ``(T, h, w, 3)`` uint8 batches,
        ``yuv420`` planar I420 ``(T, h*3/2, w)`` uint8 (even dims only)."""
        self.video_file = str(video_file)
        self.seq_len = int(sequence_length)
        self.h = int(resize_height)
        self.w = int(resize_width)
        self.do_context = do_context
        self.transfer_format = _check_transfer_format(transfer_format, self.h, self.w)
        if do_context and self.seq_len < 5:
            raise ValueError(f"context windows need a sequence_length of at least 5, got {self.seq_len}")
        # context windows step by seq_len - 4 (reference dali.py:636-651)
        self.step = self.seq_len - 4 if do_context else self.seq_len
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
        self.bbox_df = bbox_df
        self.decode_threads = (
            decode_threads if decode_threads is not None
            else default_decode_threads()
        )

    def __len__(self) -> int:
        if self.do_context:
            return int(np.ceil(max(self.frame_count - 4, 1) / self.step))
        return int(np.ceil(self.frame_count / self.seq_len))

    def _convert(self, raw_frames: list[np.ndarray], start_idx: int) -> np.ndarray:
        """Raw BGR native-resolution frames from frame ``start_idx`` on -> a
        (T, h, w, 3) RGB uint8 batch (the fused native BGR->RGB + resize,
        parallel across frames; with ``bbox_df``, each frame's crop first;
        the FILL frames past the end take the last box), as I420 under
        ``yuv420``."""
        stacked = np.stack(raw_frames)
        if self.bbox_df is None:
            rgb = native.batch_resize_rgb(stacked, self.h, self.w, swap_rb=True)
        else:
            idx = np.minimum(np.arange(start_idx, start_idx + len(stacked)), len(self.bbox_df) - 1)
            boxes = self.bbox_df[["x", "y", "h", "w"]].to_numpy()[idx]
            rgb = native.batch_crop_resize_rgb(stacked, boxes, self.h, self.w)
        return native.batch_rgb_to_i420(rgb) if self.transfer_format == "yuv420" else rgb

    def _produce(self, q: queue.Queue) -> None:
        decoder = VideoFrameDecoder(self.video_file)
        try:
            # decode raw BGR frames sequentially (the codec is serial), then
            # convert and resize a whole window in one native call; a
            # rolling buffer carries the overlap of context windows over.
            # One span a window: its reads and its convert
            n_batches = len(self)
            buf: list[np.ndarray] = []
            start = emitted = 0
            ended = False
            while emitted < n_batches:
                with tracing.span("lp.loader.decode"):
                    while not ended and len(buf) < self.seq_len:
                        frame = decoder.read_raw()
                        ended = frame is None
                        if not ended:
                            buf.append(frame)
                    # past the end, the FILL policy repeats the last decoded
                    # frame (reference dali.py:699-760): one padded window
                    # of the tail, or, for context windows, as many as it
                    # takes for every center of the counted frames to have
                    # had its window
                    if len(buf) < self.seq_len and not (buf or self.do_context):
                        break
                    window = buf[: self.seq_len] or [
                        np.zeros((decoder.orig_height, decoder.orig_width, 3), dtype=np.uint8)
                    ]
                    while len(window) < self.seq_len:
                        window.append(window[-1])
                    batch = self._convert(window, start)
                q.put(batch)
                emitted += 1
                buf = buf[self.step:]
                start += self.step
        finally:
            decoder.close()
            q.put(None)

    def _decode_window(self, decoder: "VideoFrameDecoder", k: int) -> np.ndarray:
        """Seek-decode window ``k`` ([k*step, k*step + seq_len), FILL-padded)."""
        start = k * self.step
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
        return self._convert(raw, start)

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
                    with tracing.span("lp.loader.decode"):
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


class MultiviewPredictVideoLoader:
    """Frame-synchronized ``(T, V, h, w, 3)`` batches over one video a view
    (reference dali.py:483-506): one :class:`PredictVideoLoader` a view,
    zipped. The views must have the same frame count. ``do_context``: the
    batches overlap by 4 frames, for a context model. ``transfer_format``
    ``yuv420``: ``(T, V, h*3/2, w)`` I420 batches."""

    def __init__(self, video_files: list[str], sequence_length: int, resize_height: int, resize_width: int,
                 do_context: bool = False, transfer_format: str = "rgb"):
        self.video_files = [str(v) for v in video_files]
        self.loaders = [PredictVideoLoader(v, sequence_length, resize_height, resize_width, do_context=do_context,
                                           transfer_format=transfer_format)
                        for v in self.video_files]
        counts = [ld.frame_count for ld in self.loaders]
        if len(set(counts)) != 1:
            raise RuntimeError(
                f"multiview videos have mismatched frame counts: {dict(zip(self.video_files, counts))}"
            )
        self.frame_count = counts[0]

    def __len__(self) -> int:
        return len(self.loaders[0])

    def __iter__(self):
        for windows in zip(*self.loaders):
            yield np.stack(windows, axis=1)


class MultiviewUnlabeledVideoLoader:
    """Frame-synchronized random windows for semi-supervised training of a
    multiview model: ``next()`` gives ``{"frames": (T, V, h, w, 3) uint8 RGB,
    "bbox": (T, 4V) float32}``, the same start frame in each view of one
    session (a list of one video a view), the full-frame bbox of each view.

    Window ``k``'s session and start are the k-th draws of
    ``np.random.default_rng(seed + shard_id)``, in the JAX package's order
    (a session, then a start), so both packages read the same windows. One
    background thread decodes ahead, the views of a window in parallel.
    Call :meth:`close` to stop it.
    """

    def __init__(
        self,
        sessions: list[list[str]],
        sequence_length: int,
        resize_height: int,
        resize_width: int,
        seed: int = 123456,
        shard_id: int = 0,
        prefetch_batches: int = 2,
    ):
        from concurrent.futures import ThreadPoolExecutor

        if not sessions:
            raise ValueError("no multiview unlabeled sessions found")
        self.sessions = [[str(v) for v in views] for views in sessions]
        self.seq_len = int(sequence_length)
        self.h = int(resize_height)
        self.w = int(resize_width)
        self.frame_counts = []
        for views in self.sessions:
            counts = [count_frames(v) for v in views]
            if len(set(counts)) != 1:
                raise RuntimeError(f"multiview session has mismatched frame counts: {dict(zip(views, counts))}")
            self.frame_counts.append(counts[0])
        self._rng = np.random.default_rng(int(seed) + int(shard_id))
        self._decoders: dict[str, VideoFrameDecoder] = {}
        self._pool = ThreadPoolExecutor(max_workers=max(len(v) for v in self.sessions))
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, int(prefetch_batches)))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _decode_view(self, path: str, start: int) -> tuple[np.ndarray, np.ndarray]:
        if path not in self._decoders:
            self._decoders[path] = VideoFrameDecoder(path, self.h, self.w)
        decoder = self._decoders[path]
        decoder.seek(start)
        frames = []
        for _ in range(self.seq_len):
            frame = decoder.read()
            if frame is None:
                break
            frames.append(frame)
        if not frames:  # container metadata overstated the frame count
            frames = [np.zeros((self.h, self.w, 3), dtype=np.uint8)]
        while len(frames) < self.seq_len:
            frames.append(frames[-1])
        bbox = np.tile(
            np.array([0.0, 0.0, decoder.orig_height, decoder.orig_width], dtype=np.float32), (self.seq_len, 1)
        )
        return np.stack(frames), bbox

    def _window(self) -> dict:
        s = int(self._rng.integers(len(self.sessions)))
        start = int(self._rng.integers(max(self.frame_counts[s] - self.seq_len, 1)))
        results = list(self._pool.map(lambda path: self._decode_view(path, start), self.sessions[s]))
        return {
            "frames": np.stack([r[0] for r in results], axis=1),
            "bbox": np.concatenate([r[1] for r in results], axis=1),
        }

    def _produce(self) -> None:
        try:
            while not self._stop.is_set():
                item = self._window()
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except Exception as exc:  # surface a decode failure to the consumer
            self._queue.put(exc)

    def __next__(self) -> dict:
        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                item = self._queue.get(timeout=0.5)
            except queue.Empty:
                continue
            if isinstance(item, Exception):
                self._stop.set()
                raise RuntimeError("multiview unlabeled-video decode failed") from item
            return item

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10.0)
        self._pool.shutdown(wait=True)
        for decoder in self._decoders.values():
            decoder.close()


class UnlabeledVideoLoader:
    """Random-window unlabeled-frame loader for semi-supervised training.

    Each ``__next__`` yields ``{"frames": (T, h, w, 3) uint8 RGB, "bbox":
    (T, 4) float32}``: a contiguous ``sequence_length``-frame window from a
    random start in a random video (the seeded DALI random reader, reference
    dali.py:148-152,580-592), padded by repeating its last frame, with the
    full-frame bbox ``[0, 0, orig_height, orig_width]``. With
    ``transfer_format="yuv420"`` the frames are planar I420, ``(T, h*3/2,
    w)`` uint8. Window ``k`` comes
    from ``np.random.default_rng([seed, shard_id, k])``, so the stream is the
    same for any number of decode threads. Call :meth:`close` to stop the
    worker threads.
    """

    def __init__(
        self,
        video_files: list[str],
        sequence_length: int,
        resize_height: int,
        resize_width: int,
        seed: int = 123456,
        shard_id: int = 0,
        prefetch_batches: int = 2,
        decode_threads: int | None = None,
        transfer_format: str = "rgb",
    ):
        assert len(video_files) > 0, "no unlabeled videos found"
        self.video_files = [str(v) for v in video_files]
        self.seq_len = int(sequence_length)
        self.h = int(resize_height)
        self.w = int(resize_width)
        self.transfer_format = _check_transfer_format(transfer_format, self.h, self.w)
        self.seed = int(seed)
        self.shard_id = int(shard_id)
        # fail fast on bad paths (the reference's DALI filename validation,
        # reference dali.py:449-455) instead of hanging the sampler
        missing = [v for v in self.video_files if not os.path.isfile(v)]
        if missing:
            raise FileNotFoundError(f"unlabeled video files not found: {missing}")
        self.frame_counts = [count_frames(v) for v in self.video_files]
        unreadable = [v for v, n in zip(self.video_files, self.frame_counts) if n <= 0]
        if unreadable:
            raise RuntimeError(f"could not decode any frames from: {unreadable}")
        n_workers = decode_threads if decode_threads is not None else default_decode_threads()
        self._n_workers = max(1, int(n_workers))
        self._prefetch = int(prefetch_batches)
        self._stop = threading.Event()
        self._cond = threading.Condition()
        self._results: dict[int, dict] = {}
        self._errors: list[BaseException] = []
        self._next_emit = 0
        self._threads = [
            threading.Thread(target=self._produce, args=(wid,), daemon=True)
            for wid in range(self._n_workers)
        ]
        for t in self._threads:
            t.start()

    def _window_params(self, k: int) -> tuple[int, int]:
        """``(video index, start frame)`` of the k-th window."""
        rng = np.random.default_rng([self.seed, self.shard_id, k])
        vid_idx = int(rng.integers(len(self.video_files)))
        n = self.frame_counts[vid_idx]
        start = int(rng.integers(max(n - self.seq_len, 1)))
        return vid_idx, start

    def _decode_window(self, decoder: VideoFrameDecoder, start: int) -> dict:
        decoder.seek(start)
        frames = []
        for _ in range(self.seq_len):
            frame = decoder.read()
            if frame is None:
                break
            frames.append(frame)
        if not frames:
            frames = [np.zeros((self.h, self.w, 3), dtype=np.uint8)]
        while len(frames) < self.seq_len:
            frames.append(frames[-1])
        bbox = np.tile(
            np.array([0.0, 0.0, decoder.orig_height, decoder.orig_width], dtype=np.float32),
            (self.seq_len, 1),
        )
        stacked = np.stack(frames)
        if self.transfer_format == "yuv420":
            stacked = native.batch_rgb_to_i420(stacked)
        return {"frames": stacked, "bbox": bbox}

    def _produce(self, wid: int) -> None:
        decoders: dict[int, VideoFrameDecoder] = {}
        max_lead = self._n_workers + self._prefetch
        try:
            k = wid
            while not self._stop.is_set():
                with self._cond:
                    while k - self._next_emit >= max_lead and not self._stop.is_set():
                        self._cond.wait(timeout=0.5)
                if self._stop.is_set():
                    return
                vid_idx, start = self._window_params(k)
                if vid_idx not in decoders:
                    decoders[vid_idx] = VideoFrameDecoder(self.video_files[vid_idx], self.h, self.w)
                batch = self._decode_window(decoders[vid_idx], start)
                with self._cond:
                    self._results[k] = batch
                    self._cond.notify_all()
                k += self._n_workers
        except BaseException as exc:  # surface a worker's death to the consumer
            with self._cond:
                self._errors.append(exc)
                self._cond.notify_all()
        finally:
            for d in decoders.values():
                d.close()

    def __next__(self) -> dict:
        with self._cond:
            k = self._next_emit
            while k not in self._results and not self._errors and not self._stop.is_set():
                self._cond.wait(timeout=0.5)
            if self._errors:
                self._stop.set()
                self._cond.notify_all()
                raise RuntimeError("unlabeled-video decode worker failed") from self._errors[0]
            if self._stop.is_set() and k not in self._results:
                raise StopIteration
            batch = self._results.pop(k)
            self._next_emit = k + 1
            self._cond.notify_all()
        return batch

    def close(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        # join before the decoders are garbage-collected (cv2 teardown from a
        # live daemon thread can crash at interpreter shutdown)
        for t in self._threads:
            t.join(timeout=10.0)


def undo_affine_transform_batch(keypoints: torch.Tensor, transforms: torch.Tensor) -> torch.Tensor:
    """Map ``(B, 2K)`` keypoints predicted on augmented frames back to the
    original frames, through the inverse of each frame's forward ``(B, 2, 3)``
    matrix (``augmented = M @ [x, y, 1]``; reference data/utils.py:192-235).
    Differentiable in the keypoints. The 2x2 inverse is the closed form, so
    that nothing waits for the device (``torch.linalg.inv`` checks for
    singular matrices on the host)."""
    b = keypoints.shape[0]
    kp = keypoints.reshape(b, -1, 2)
    m = transforms.to(keypoints.dtype)
    a, bb, c, d = m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 1, 1]
    a_inv = torch.stack([torch.stack([d, -bb], -1), torch.stack([-c, a], -1)], -2) / (a * d - bb * c)[:, None, None]
    kp_orig = torch.einsum("bij,bkj->bki", a_inv, kp - m[:, None, :, 2])
    return kp_orig.reshape(b, -1)
