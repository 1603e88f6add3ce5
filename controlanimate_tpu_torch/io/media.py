"""Media IO for the vid2vid loop: ffmpeg subprocess framing on threads with
bounded queues, and array / directory sources and sinks for runs without
ffmpeg.

A copy of `controlanimate_tpu/io/media.py` (which imports no jax; the port
keeps its own copy all the same), except that videos are probed with
`ffprobe` instead of OpenCV, which the port does not import. `PIL` is
imported only inside the functions that need it. Encoder and decoder
processes are closed with `wait()`.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import subprocess
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np


def ffmpeg_available(ffmpeg_path: str = "ffmpeg") -> bool:
    return shutil.which(ffmpeg_path) is not None


def probe_video(path: str, ffmpeg_path: str = "ffmpeg") -> tuple[float, int, int, int]:
    """(fps, frame_count, width, height) of the first video stream, read with
    the `ffprobe` beside `ffmpeg_path` (the JAX package asks OpenCV;
    reference: modules/utils.py:61-72). The frame count is the container's
    (0 where it has none)."""
    exe = Path(ffmpeg_path)
    ffprobe = str(exe.with_name(exe.name.replace("ffmpeg", "ffprobe")))
    try:
        proc = subprocess.run(
            [ffprobe, "-v", "error", "-select_streams", "v:0", "-show_entries",
             "stream=width,height,r_frame_rate,nb_frames", "-of", "json", path],
            capture_output=True, text=True,
        )
    except OSError as e:
        raise RuntimeError(f"ffprobe could not run ({ffprobe}): {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"ffprobe could not read {path}: {proc.stderr.strip()}")
    stream = json.loads(proc.stdout)["streams"][0]
    num, _, den = stream.get("r_frame_rate", "0/1").partition("/")
    fps = float(num) / float(den or 1) if float(den or 1) else 0.0
    n = stream.get("nb_frames", "0")
    return fps, int(n) if str(n).isdigit() else 0, int(stream["width"]), int(stream["height"])


class FrameSource:
    """Iterator of (H, W, 3) uint8 frames."""

    def read(self) -> Optional[np.ndarray]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class FrameSink:
    def write(self, frame: np.ndarray) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class FFMPEGFrameSource(FrameSource):
    """Decode a video to raw RGB frames over a pipe, prefetched on a thread.

    Mirrors the reference decoder invocation including the color filter and
    fps resample (reference: scripts/vid2vid.py:97-109 — filter
    `eq=brightness=0.06:saturation=4` is reproduced as the default since
    output parity depends on it)."""

    def __init__(
        self,
        path: str,
        width: int,
        height: int,
        fps: float,
        start_time: Optional[str] = None,
        end_time: Optional[str] = None,
        ffmpeg_path: str = "ffmpeg",
        color_filter: str = "eq=brightness=0.06:saturation=4",
        prefetch: int = 64,
    ):
        self.width, self.height = width, height
        cmd = [ffmpeg_path, "-hide_banner", "-loglevel", "error"]
        if start_time:
            cmd += ["-ss", start_time]
        cmd += ["-i", path]
        if end_time:
            cmd += ["-to", end_time]
        vf = f"scale={width}:{height}"
        if color_filter:
            vf = f"{color_filter},{vf}"
        cmd += [
            "-vf", vf, "-r", str(fps),
            "-f", "rawvideo", "-pix_fmt", "rgb24", "pipe:1",
        ]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, bufsize=10**8)
        self._q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue(maxsize=prefetch)
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _pump(self):
        nbytes = self.width * self.height * 3
        try:
            while True:
                raw = self.proc.stdout.read(nbytes)
                if not raw or len(raw) < nbytes:
                    break
                frame = np.frombuffer(raw, np.uint8).reshape(self.height, self.width, 3)
                self._q.put(frame)
        finally:
            self._q.put(None)

    def read(self) -> Optional[np.ndarray]:
        return self._q.get()

    def close(self):
        try:
            self.proc.stdout.close()
        except Exception:
            pass
        self.proc.wait(timeout=30)


class FFMPEGFrameSink(FrameSink):
    """Encode raw frames to x264 via a pipe, buffered on a thread
    (reference: scripts/vid2vid.py:123-136).

    pix_fmt "rgb24" matches the reference byte-for-byte; "yuv420p" accepts
    device-converted I420 buffers (half the bytes — x264 consumes yuv420p
    natively, the reference merely had swscale do this conversion on host)."""

    def __init__(
        self,
        path: str,
        width: int,
        height: int,
        fps: float,
        crf: int = 23,
        ffmpeg_path: str = "ffmpeg",
        queue_size: int = 64,
        pix_fmt: str = "rgb24",
    ):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        self.pix_fmt = pix_fmt
        cmd = [
            ffmpeg_path, "-hide_banner", "-loglevel", "error", "-y",
            "-f", "rawvideo", "-pix_fmt", pix_fmt,
            "-s", f"{width}x{height}", "-r", str(fps),
            "-i", "pipe:0",
            "-c:v", "libx264", "-preset", "medium", "-crf", str(crf),
            "-pix_fmt", "yuv420p", path,
        ]
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, bufsize=10**8)
        self._q: "queue.Queue[Optional[bytes]]" = queue.Queue(maxsize=queue_size)
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _pump(self):
        while True:
            item = self._q.get()
            if item is None:
                break
            try:
                self.proc.stdin.write(item)
            except BrokenPipeError:
                break
        try:
            self.proc.stdin.close()
        except Exception:
            pass

    def write(self, frame: np.ndarray) -> None:
        self._q.put(np.ascontiguousarray(frame, np.uint8).tobytes())

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=60)
        # real wait, not the reference's time.sleep(10) (vid2vid.py:273)
        self.proc.wait(timeout=120)


class ArrayFrameSource(FrameSource):
    """In-memory source for tests / programmatic use."""

    def __init__(self, frames: np.ndarray):
        self._frames = list(np.asarray(frames, np.uint8))
        self._i = 0

    def read(self) -> Optional[np.ndarray]:
        if self._i >= len(self._frames):
            return None
        f = self._frames[self._i]
        self._i += 1
        return f


class DirectoryFrameSource(FrameSource):
    """Read numbered PNG/JPG frames from a directory (ffmpeg-less input)."""

    def __init__(self, directory: str, width: Optional[int] = None, height: Optional[int] = None):
        from PIL import Image

        self._paths = sorted(
            p for p in Path(directory).iterdir() if p.suffix.lower() in (".png", ".jpg", ".jpeg")
        )
        self._i = 0
        self._size = (width, height)
        self._Image = Image

    def read(self) -> Optional[np.ndarray]:
        if self._i >= len(self._paths):
            return None
        img = self._Image.open(self._paths[self._i]).convert("RGB")
        if self._size[0]:
            img = img.resize(self._size)
        self._i += 1
        return np.asarray(img, np.uint8)


class ArrayFrameSink(FrameSink):
    def __init__(self):
        self.frames: list[np.ndarray] = []

    def write(self, frame: np.ndarray) -> None:
        self.frames.append(np.asarray(frame, np.uint8))


def _save_png(frame: np.ndarray, path: Path) -> None:
    from PIL import Image

    Image.fromarray(frame).save(path, compress_level=1)


class DirectoryFrameSink(FrameSink):
    """Numbered-PNG sink (ffmpeg-less output). `start_index` lets a resumed
    run append after the frames its previous segment already wrote — the
    directory plays the role the per-segment mp4 files + concat play on the
    ffmpeg path; without it a resume would overwrite 0001..N with the
    post-checkpoint frames. PNGs are written at zlib level 1 (the same
    pixels as PIL's default level 6, in larger files, faster) by
    `ENCODERS` worker threads (PIL releases the interpreter lock while it
    compresses), at most 2 x `ENCODERS` frames in flight; `close` waits for
    every file and raises the first failure."""

    ENCODERS = 4

    def __init__(self, directory: str, start_index: int = 0):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._i = int(start_index)
        self._pool = ThreadPoolExecutor(max_workers=self.ENCODERS, thread_name_prefix="png")
        self._pending: deque = deque()

    def write(self, frame: np.ndarray) -> None:
        self._i += 1
        # a copy: the caller may reuse its buffer before the worker runs
        self._pending.append(self._pool.submit(
            _save_png, np.array(frame, np.uint8), self.dir / f"{self._i:04d}.png"))
        while len(self._pending) > 2 * self.ENCODERS:
            self._pending.popleft().result()

    def close(self) -> None:
        try:
            while self._pending:
                self._pending.popleft().result()
        finally:
            self._pool.shutdown(wait=True)


def concat_videos(segments: list[str], output_path: str, ffmpeg_path: str = "ffmpeg") -> None:
    """Losslessly concatenate same-codec segments (resume support)."""
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        for s in segments:
            f.write(f"file '{Path(s).resolve()}'\n")
        list_path = f.name
    subprocess.run(
        [ffmpeg_path, "-hide_banner", "-loglevel", "error", "-y",
         "-f", "concat", "-safe", "0", "-i", list_path, "-c", "copy", output_path],
        check=True,
    )
    os.unlink(list_path)


def video_to_high_fps(
    output_path: str,
    video_path: str,
    audio_source_path: Optional[str],
    target_fps: float,
    crf: int = 23,
    ffmpeg_path: str = "ffmpeg",
    start_time: Optional[str] = None,
    end_time: Optional[str] = None,
) -> None:
    """Audio mux + minterpolate motion-compensated fps upscale
    (reference: modules/utils.py:26-58, executed there via os.system; here a
    checked subprocess)."""
    cmd = [ffmpeg_path, "-hide_banner", "-loglevel", "error", "-y", "-i", video_path]
    if audio_source_path:
        if start_time:
            cmd += ["-ss", start_time]
        cmd += ["-i", audio_source_path]
        if end_time:
            cmd += ["-to", end_time]
    cmd += [
        "-vf",
        f"minterpolate=fps={target_fps}:mi_mode=mci:mc_mode=aobmc:me_mode=bidir:vsbmc=1",
        "-c:v", "libx264", "-crf", str(crf), "-pix_fmt", "yuv420p",
    ]
    if audio_source_path:
        cmd += ["-map", "0:v:0", "-map", "1:a:0?", "-c:a", "aac", "-shortest"]
    cmd += [output_path]
    subprocess.run(cmd, check=True)
