"""Host-side video input and output.

Counterpart of ``padel_analytics_tpu/utils/video.py``: decode
(`frame_generator`, `read_video`), encode (`save_video`, the in-process
`VideoWriter`, and `SubprocessVideoWriter`, which feeds one shared child
encoder process, `encoder_worker.py`, over a pipe) and `make_video_writer`.
OpenCV is imported only where a video file is opened or written, so the rest
of the port runs without it. A `MemoryClip` (decoded frames in memory)
stands in for a video path anywhere one is taken, for callers that decode
elsewhere or run where OpenCV is absent.
"""

from __future__ import annotations

import queue
import struct
import subprocess
import sys
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class MemoryClip:
    """A clip already decoded: RGB uint8 (H, W, 3) frames and their rate."""

    frames: Sequence[np.ndarray]
    fps: float


@dataclass(frozen=True)
class VideoInfo:
    """Source video metadata."""

    width: int
    height: int
    fps: float
    total_frames: int

    @property
    def resolution_wh(self) -> tuple[int, int]:
        return (self.width, self.height)

    @classmethod
    def from_video_path(cls, video_path: str | Path | MemoryClip) -> "VideoInfo":
        if isinstance(video_path, MemoryClip):
            h, w = video_path.frames[0].shape[:2]
            return cls(width=w, height=h, fps=float(video_path.fps),
                       total_frames=len(video_path.frames))
        import cv2

        cap = cv2.VideoCapture(str(video_path))
        if not cap.isOpened():
            raise FileNotFoundError(f"cannot open video: {video_path}")
        info = cls(
            width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            fps=float(cap.get(cv2.CAP_PROP_FPS)),
            total_frames=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
        )
        cap.release()
        return info


def frame_generator(
    video_path: str | Path | MemoryClip,
    start: int = 0,
    stride: int = 1,
    end: Optional[int] = None,
) -> Iterator[np.ndarray]:
    """Yield RGB uint8 frames (RGB at the decode boundary)."""
    if isinstance(video_path, MemoryClip):
        yield from video_path.frames[start:end:stride]
        return
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    if start:
        cap.set(cv2.CAP_PROP_POS_FRAMES, start)
    index = start
    try:
        while True:
            ok, frame_bgr = cap.read()
            if not ok:
                break
            if end is not None and index >= end:
                break
            if (index - start) % stride == 0:
                yield cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB)
            index += 1
    finally:
        cap.release()


def read_video(path: str | Path,
               max_frames: Optional[int] = None) -> tuple[list[np.ndarray], float, int, int]:
    """Eager RGB read of a whole video: (frames, fps, width, height)."""
    info = VideoInfo.from_video_path(path)
    frames = []
    for frame in frame_generator(path, end=max_frames):
        frames.append(frame)
        if max_frames is not None and len(frames) >= max_frames:
            break
    return frames, info.fps, info.width, info.height


def save_video(frames, path: str | Path, fps: float, h: Optional[int] = None,
               w: Optional[int] = None) -> None:
    """Write RGB frames to an mp4v file."""
    import cv2

    frames = list(frames)
    if not frames:
        raise ValueError("no frames to save")
    if h is None or w is None:
        h, w = frames[0].shape[:2]
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), float(fps), (w, h))
    try:
        for frame in frames:
            out.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    finally:
        out.release()


class VideoWriter:
    """Streaming RGB frame writer, encoded in this process (mp4v)."""

    def __init__(self, path: str | Path, fps: float, resolution_wh: tuple[int, int]):
        import cv2

        self._cv2 = cv2
        self._writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), float(fps),
                                       resolution_wh)

    def write(self, frame_rgb: np.ndarray) -> None:
        self._writer.write(self._cv2.cvtColor(frame_rgb, self._cv2.COLOR_RGB2BGR))

    def release(self) -> None:
        self._writer.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
        return False


# One encoder child per process, reused by every SubprocessVideoWriter (a
# child's start-up costs seconds); one writer at a time holds it, under the
# lock.
_ENCODER_LOCK = threading.Lock()
_ENCODER_PROC: Optional[subprocess.Popen] = None


def _shared_encoder_proc() -> subprocess.Popen:
    """The live shared child, started anew if it is absent or has exited.
    The caller holds _ENCODER_LOCK."""
    global _ENCODER_PROC
    if _ENCODER_PROC is None or _ENCODER_PROC.poll() is not None:
        # Run by path, not with -m, so the child imports nothing of the
        # package (and no torch).
        worker = Path(__file__).with_name("encoder_worker.py")
        _ENCODER_PROC = subprocess.Popen([sys.executable, str(worker)],
                                         stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    return _ENCODER_PROC


def shutdown_shared_encoder() -> None:
    """Stop the shared encoder child, if there is one."""
    global _ENCODER_PROC
    proc, _ENCODER_PROC = _ENCODER_PROC, None
    if proc is None:
        return
    if proc.poll() is None:
        try:
            proc.stdin.write(b"Q")
            proc.stdin.flush()
            proc.stdin.close()
            proc.wait(timeout=10)
        except (OSError, ValueError, subprocess.TimeoutExpired):
            proc.kill()
            proc.wait()
    for pipe in (proc.stdin, proc.stdout):
        if pipe is not None and not pipe.closed:
            pipe.close()


class SubprocessVideoWriter:
    """A VideoWriter whose encode runs in the shared child process, fed raw
    RGB frames over its stdin, so the encode overlaps this process's work
    at the level of the OS.

    write() queues the frame for a feeder thread (at most QUEUE_DEPTH
    frames wait); release() blocks until the child acknowledges that the
    container is closed, so any encode backlog is paid inside the caller's
    timing. The writer holds the shared child's lock from construction to
    release(); a constructor that fails releases it."""

    QUEUE_DEPTH = 4

    def __init__(self, path: str | Path, fps: float, resolution_wh: tuple[int, int]):
        _ENCODER_LOCK.acquire()
        try:
            self._proc = _shared_encoder_proc()
            w, h = resolution_wh
            pb = str(path).encode("utf-8")
            self._proc.stdin.write(b"O" + struct.pack("<H", len(pb)) + pb
                                   + struct.pack("<dII", float(fps), w, h))
            self._proc.stdin.flush()
        except BaseException:
            _ENCODER_LOCK.release()
            raise
        self._released = False
        self._q: queue.Queue = queue.Queue(maxsize=self.QUEUE_DEPTH)
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._feed, daemon=True)
        self._thread.start()

    def _feed(self) -> None:
        try:
            while True:
                frame = self._q.get()
                if frame is None:
                    return
                self._proc.stdin.write(b"F")
                self._proc.stdin.write(frame.tobytes())
        except (OSError, ValueError) as e:  # the child died or the pipe closed
            self._exc = e
            while self._q.get() is not None:  # never leave the producer blocked
                pass

    def write(self, frame_rgb: np.ndarray) -> None:
        if self._exc is not None:
            raise RuntimeError("encoder child failed") from self._exc
        self._q.put(np.ascontiguousarray(frame_rgb))

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        try:
            self._q.put(None)
            self._thread.join()
            if self._exc is not None:
                raise RuntimeError("encoder child failed") from self._exc
            self._proc.stdin.write(b"C")
            self._proc.stdin.flush()
            ack = self._proc.stdout.read(1)
            if ack != b"K":
                raise RuntimeError(f"encoder child died (ack {ack!r}, rc {self._proc.poll()})")
        finally:
            _ENCODER_LOCK.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
        return False


def make_video_writer(path: str | Path, fps: float, resolution_wh: tuple[int, int],
                      encoder: str = "inline"):
    """'inline': encode in this process; 'subprocess': in the shared child
    (the same mp4v output)."""
    if encoder == "subprocess":
        return SubprocessVideoWriter(path, fps, resolution_wh)
    if encoder != "inline":
        raise ValueError(f"unknown encoder {encoder!r}")
    return VideoWriter(path, fps, resolution_wh)
