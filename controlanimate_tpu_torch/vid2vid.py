"""The vid2vid loop: a video stream through overlapping windows, stitched on
the device, to a frame sink.

Counterpart of `scripts/vid2vid.py` `vid2vid` in its sequential form: frame
source -> 16-frame windows with 8-frame overlap -> `pipeline.animate` ->
device stitch (color match, overlap blend, I420) -> deferred emit to the
sink, with checkpoint / resume, cooperative cancel and txt2vid up to
`total_frames`. Frames stay on the device from the decode to the emit; each
window is read back once, into pinned host memory, while the next window
computes. Without an injected pipeline the models are built from the model
zoo the config names (`pipelines/facade.py` `build_from_disk`).

With `upscale` > 1 each emitted window goes through the RealESRGAN
`Upscaler` (`models/upscaler.py`, its x4 tail on K4; with
`use_face_enhancer`, GFPGAN's face restoration after it, in the
`upscale_first` order the config names) on the device right after the
stitch, and is packed to I420 there when the sink takes yuv420p (upscale 1,
or 4 without the face enhancer, as in the JAX loop), before its readback
starts; the tail flush after the loop goes through it too. The sink is
opened at the upscaled size.

Host / device overlap, as in the JAX loop: with `overlap_host_work` a worker
thread reads window N+1 and uploads it on a side CUDA stream while window N
runs (not when `max_windows` ends the run with window N); the main stream
waits on that upload's event. The checkpoint worker
reads the stitch state back on its own thread; the stitch returns new tensors
and nothing writes into them, so a snapshot may hold references.

With ControlNets each window's condition maps are annotated on the device
(`pipeline.prepare_cond_images`, timed as `annotate`) before the window runs:
by the prefetch worker on its side stream for the window it uploads, as the
JAX loop pre-annotates, else on the main thread (the first window, runs
without `overlap_host_work`, and loop-back). With `loop_back_frames` the
overlap slots of a window's input hold the previous window's generated
overlap frames, for the annotators and the VAE encode alike (as in the JAX
loop); the staged upload is copied before they go in, and overlap-latent
reuse is off (the facade's rule).

Every window kind of the engine runs here: native LCM, and the multi-step
samplers with classifier-free guidance (an overlap window at an
`overlap_strength` below 1 starts from the previous window's outputs). With
`use_ipadapter` and `do_initial_generation` the run's first window runs
twice, as in the JAX loop: once as any window, then again with its own last
`overlap_length` frames as the last outputs (the IP-Adapter's anchor is the
first of them) at `overlap_strength`, the first pass's first frame the
stitch's color-match anchor.

Segment-parallel runs (`parallel_segments` S > 1, on one device; the JAX
loop's `_run_segments`): the source is read whole and split into S
contiguous segments of equal length (the last padded with repeats of its
final frame), and window w of every segment runs as one batched window,
the segment axis the engine's batch axis, so that each segment comes out as
a run of that segment alone with the same seed would. The prefetch worker
uploads (and annotates) window w+1 on the side stream while window w runs;
the batched stitch keeps every segment's overlap, anchor and blend to
itself; each window's emit is read back while the next one runs and held on
the host; after the last window the segments go to the sink in order,
their pad trimmed, upscaled F frames at a time. No checkpoint is written
(`resume` and `save_frames` raise ValueError, as does a run without input
frames or with `overlap_length` >= `frame_count`), and a stop request ends
the run with nothing written (`canceled`).

Not ported yet, and rejected by `config.require_ported`: device meshes
(M15b), and M14's `token_merge_ratio` and `encoder_reuse_every`. The C++
ring buffer frame pipe (`use_native_framepipe`) is not ported: the loop
takes the Python ffmpeg pipe, as the JAX loop does where that pipe cannot
be built. JAX behaviours not copied: a missing RealESRGAN file raises FileNotFoundError
(the JAX loop drops the upscaler and writes frames of the wrong size into a
sink opened at the upscaled size); an upscale that fails raises (the JAX
loop falls back to the host); and `save_frames` dumps the frames the sink
got, upscaled (the JAX loop dumps them unscaled behind a yuv420p sink).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .config import RunConfig, StitchState, require_ported, torch_dtype
from .io import media
from .ops.stitch import stitch_window, stitch_window_batch
from .ops.yuv import rgb_to_yuv420
from .utils.profiling import PhaseTimers, maybe_trace

STATE_FILE = "stitch_state.npz"


def _host(x) -> Optional[np.ndarray]:
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _snapshot_state(state: StitchState, consumed: int, frames_written: int,
                    segment: int) -> dict:
    """Checkpoint values at a consistent point, without a device readback:
    the state's tensors are never written after the stitch made them, so
    holding references is safe; the checkpoint worker reads them back."""
    return dict(
        epoch=state.epoch,
        seed=state.seed,
        consumed=consumed,
        frames_written=frames_written,
        segment=segment,
        overlap_frames=state.overlap_frames,
        overlap_input_frames=list(state.overlap_input_frames),
        last_output_frames=state.last_output_frames,
        last_output_frame=state.last_output_frame,
    )


def _save_state(out_dir: Path, snap: dict) -> None:
    """Write `stitch_state.npz` atomically (a temporary file, then a rename),
    with the JAX loop's keys, so a crash mid-save keeps the previous one."""

    def host(x, fallback_shape=(0,)):
        return _host(x) if x is not None else np.zeros(fallback_shape)

    tmp = out_dir / "stitch_state.tmp.npz"
    np.savez(
        tmp,
        epoch=snap["epoch"],
        seed=snap["seed"],
        consumed=snap["consumed"],
        frames_written=snap["frames_written"],
        segment=snap["segment"],
        overlap_frames=host(snap["overlap_frames"]),
        overlap_input_frames=(
            np.stack(snap["overlap_input_frames"])
            if snap["overlap_input_frames"] else np.zeros((0,))
        ),
        last_output_frames=host(snap["last_output_frames"]),
        last_output_frame=host(snap["last_output_frame"]),
    )
    os.replace(tmp, out_dir / STATE_FILE)


def _load_state(out_dir: Path) -> tuple[StitchState, int, int, int] | None:
    path = out_dir / STATE_FILE
    if not path.exists():
        return None
    z = np.load(path)
    state = StitchState(epoch=int(z["epoch"]), seed=int(z["seed"]))
    if z["overlap_frames"].ndim == 4:
        state.overlap_frames = z["overlap_frames"]
    if z["overlap_input_frames"].ndim == 4:
        state.overlap_input_frames = list(z["overlap_input_frames"])
    if z["last_output_frames"].ndim == 4:
        state.last_output_frames = z["last_output_frames"]
    if z["last_output_frame"].ndim == 3:
        state.last_output_frame = z["last_output_frame"]
    return state, int(z["consumed"]), int(z["frames_written"]), int(z["segment"])


def _round64(x: int) -> int:
    return max((int(x) // 64) * 64, 64)


class _Stager:
    """Uploads a prefetched window to the device and, given an `annotate`
    function, computes its condition maps there. On CUDA both run on a side
    stream (the copy from pinned memory), and the main stream waits on their
    event before it uses them; on the CPU they are used as they are."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def upload(self, batch: np.ndarray, annotate=None):
        host = torch.from_numpy(batch)
        if self.stream is None:
            return host, None, None if annotate is None else annotate(host)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            staged = host.pin_memory().to(self.device, non_blocking=True)
            cond = None if annotate is None else annotate(staged)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return staged, ready, cond

    def claim(self, staged: torch.Tensor, ready, cond=None):
        """Make the main stream wait for the upload (and the annotation) and
        own the tensors; returns (frames, condition maps or None)."""
        if ready is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_event(ready)
            for t in [staged, *(cond or ())]:
                t.record_stream(main)
        return staged, cond


class _Readback:
    """A device tensor copied into pinned host memory without blocking; the
    host reads it once the copy's event has completed."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record(torch.cuda.current_stream(t.device))
        else:
            self.host, self.done = t, None

    def numpy(self) -> np.ndarray:
        if self.done is not None:
            self.done.synchronize()
        return self.host.numpy()


def vid2vid(
    config_path: Optional[str] = None,
    config: Optional[RunConfig] = None,
    pipeline=None,
    frame_source: Optional[media.FrameSource] = None,
    frame_sink: Optional[media.FrameSink] = None,
    upscaler=None,
    max_windows: Optional[int] = None,
    progress=None,
    should_stop=None,
    device="cuda",
) -> dict:
    """Run the vid2vid loop; returns a summary dict (frames written, seed,
    output path, windows, canceled, phase timers).

    `pipeline` needs `animate(input_frames, last_output_frames, *, overlaps,
    strength, seed, epoch)` returning a window's (F, H, W, 3) uint8 frames on
    its device, and a `device` attribute; None builds
    `ControlAnimatePipeline(config, device=device)` from the model zoo on
    disk, timed as the `build_pipeline` phase (`device` is used for nothing
    else). `upscaler` needs `upscale_batch_device(frames)` mapping (F, H, W, 3)
    uint8 device frames to upscaled ones; None builds
    `Upscaler(config.upscale, ...)` from `upscaler_model_path` (and the face
    models' paths with `use_face_enhancer`) when `upscale` > 1; with a face
    enhancer the summary counts the faces its detector found. `progress`, if
    given, is called after every window with {"windows", "frames_written",
    "frames_generated"} ({"windows", "segments", "frames_generated"} in a
    segment-parallel run, whose summary also has `segments` and counts
    `windows` a segment). `should_stop`, if
    given, is polled at every window boundary; a truthy return stops the run
    as a `max_windows` interruption does (pending emits flush, a resumable
    checkpoint is saved) and the summary says `canceled`; a segment-parallel
    run stops with nothing written."""
    cfg = config or RunConfig.from_yaml(config_path)
    require_ported(cfg)
    has_input = bool(cfg.input_video_path) and Path(cfg.input_video_path).exists()
    segmented = cfg.parallel_segments > 1
    if segmented:
        _check_segments(cfg, has_input or frame_source is not None)

    # geometry: multiples of 64, probed from the input video when unset
    width, height = cfg.width, cfg.height
    if has_input and (not width or not height):
        _, _, width, height = media.probe_video(cfg.input_video_path, cfg.ffmpeg_path)
    width, height = _round64(width or 512), _round64(height or 512)
    cfg = cfg.replace(width=width, height=height)
    upscale = max(float(cfg.upscale), 1.0)
    out_w, out_h = int(width * upscale), int(height * upscale)

    seed = cfg.seed if cfg.seed != -1 else int(np.random.randint(1, 2**16))

    out_dir = Path(cfg.output_video_dir)
    resumed = _load_state(out_dir) if cfg.resume else None

    # the models first: a missing weights file raises before any file opens
    timers = PhaseTimers()
    if pipeline is None:
        from .pipelines.facade import ControlAnimatePipeline

        with timers.phase("build_pipeline"):
            pipeline = ControlAnimatePipeline(cfg, device=device)
    device = torch.device(getattr(pipeline, "device", "cuda"))
    if upscaler is None and upscale > 1.0:
        from .models.upscaler import Upscaler

        upscaler = Upscaler(upscale, model_path=cfg.upscaler_model_path,
                            dtype=torch_dtype(cfg.dtype), device=device,
                            use_face_enhancer=cfg.use_face_enhancer,
                            upscale_first=cfg.upscale_first,
                            face_enhancer_model_path=cfg.face_enhancer_model_path,
                            face_detector_model_path=cfg.face_detector_model_path)

    # frame source and sink
    own_source = frame_source is None
    if frame_source is None and has_input:
        if media.ffmpeg_available(cfg.ffmpeg_path):
            frame_source = media.FFMPEGFrameSource(
                cfg.input_video_path, width, height, cfg.fps,
                start_time=cfg.start_time, end_time=cfg.end_time,
                ffmpeg_path=cfg.ffmpeg_path,
            )
        elif Path(cfg.input_video_path).is_dir():
            frame_source = media.DirectoryFrameSource(cfg.input_video_path, width, height)
        else:
            raise RuntimeError(
                "input video given but ffmpeg is unavailable; provide a frame "
                "directory or an explicit frame_source"
            )

    out_dir.mkdir(parents=True, exist_ok=True)
    segment = resumed[3] + 1 if resumed else 0
    raw_video_path = out_dir / f"output_raw_{segment:03d}.mp4"
    own_sink = frame_sink is None
    if frame_sink is None:
        if media.ffmpeg_available(cfg.ffmpeg_path):
            # I420 halves the readback; the JAX loop packs it only at scale
            # 1, or 4 without the face enhancer (its device upscale path), and
            # the port keeps that rule
            device_path = upscale == 1.0 or (abs(upscale - 4.0) < 1e-6
                                             and not cfg.use_face_enhancer)
            pix_fmt = "yuv420p" if device_path else "rgb24"
            frame_sink = media.FFMPEGFrameSink(
                str(raw_video_path), out_w, out_h, cfg.fps,
                crf=cfg.crf, ffmpeg_path=cfg.ffmpeg_path, pix_fmt=pix_fmt,
            )
        else:
            # on resume, number after the previous segment's frames
            frame_sink = media.DirectoryFrameSink(
                str(out_dir / "frames"), start_index=resumed[2] if resumed else 0)
    sink_pix_fmt = getattr(frame_sink, "pix_fmt", "rgb24")

    with contextlib.ExitStack() as cleanup:
        if own_source and frame_source is not None:
            cleanup.callback(frame_source.close)
        if own_sink:
            cleanup.callback(frame_sink.close)
        if segmented:
            summary = _run_segments(cfg, pipeline, upscaler, device, frame_source, frame_sink,
                                    sink_pix_fmt, seed, timers, cleanup, max_windows, progress,
                                    should_stop)
        else:
            summary = _run(cfg, pipeline, upscaler, device, frame_source, frame_sink,
                           sink_pix_fmt, resumed, seed, segment, out_dir, timers, cleanup,
                           max_windows, progress, should_stop)

    # audio mux and frame interpolation of the encoded video (a canceled
    # segment-parallel run wrote nothing)
    final_path = out_dir / "output.mp4"
    if (own_sink and isinstance(frame_sink, media.FFMPEGFrameSink)
            and media.ffmpeg_available(cfg.ffmpeg_path)
            and not (segmented and summary["canceled"])):
        # the parts of a resumed run; a segment-parallel run is never resumed
        parts = [raw_video_path] if segmented else sorted(out_dir.glob("output_raw_*.mp4"))
        src = raw_video_path
        if len(parts) > 1:
            src = out_dir / "output_raw_joined.mp4"
            media.concat_videos([str(s) for s in parts], str(src), cfg.ffmpeg_path)
        media.video_to_high_fps(
            str(final_path), str(src),
            cfg.input_video_path if has_input else None,
            cfg.fps_ffmpeg, crf=cfg.crf, ffmpeg_path=cfg.ffmpeg_path,
            start_time=cfg.start_time, end_time=cfg.end_time,
        )
    timers.dump(out_dir / "phase_timers.json")
    if own_sink and isinstance(frame_sink, media.DirectoryFrameSink):
        output_path = frame_sink.dir
    else:
        output_path = final_path if final_path.exists() else raw_video_path
    fe = getattr(upscaler, "face_enhancer", None)
    if fe is not None:  # the detector's work, for the run's report
        summary["faces"] = {"found": fe.faces_found, "frames_searched": fe.frames_searched}
    return {**summary, "output": str(output_path), "timers": timers.summary()}


def _run(cfg, pipeline, upscaler, device, frame_source, frame_sink, sink_pix_fmt, resumed,
         seed, segment, out_dir, timers, cleanup, max_windows, progress, should_stop) -> dict:
    """The epoch loop of `vid2vid` (a resumed run takes the checkpoint's
    seed); threads it starts are shut down through `cleanup`."""
    if resumed:
        state, consumed, frames_written, _ = resumed
        seed = state.seed
        # the overlap inputs live in the checkpoint: resume at the first unread frame
        for _ in range(consumed):
            if frame_source is not None:
                frame_source.read()
    else:
        state = StitchState(seed=seed)
        consumed = frames_written = 0
    window = cfg.frame_count
    overlap_length = cfg.overlap_length
    # the IP-Adapter's initial double pass runs on the run's first window
    initial_pass = cfg.use_ipadapter and cfg.do_initial_generation

    def read_n(n: int) -> list[np.ndarray]:
        out = []
        for _ in range(n):
            if frame_source is None:
                break
            f = frame_source.read()
            if f is None:
                break
            out.append(f)
        return out

    # one worker reads and uploads window N+1 while window N runs
    executor = stager = None
    pending_prefetch = None
    if cfg.overlap_host_work and frame_source is not None:
        executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="prefetch")
        cleanup.callback(executor.shutdown, wait=True)
        stager = _Stager(device)

    # checkpoint saves read the state back on their own worker
    ckpt_executor = None
    ckpt_futures: list = []
    if cfg.checkpoint_interval > 0:
        ckpt_executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
        cleanup.callback(ckpt_executor.shutdown, wait=True)

    def submit_checkpoint(snap: dict):
        def run():
            with timers.phase("checkpoint"):
                _save_state(out_dir, snap)

        ckpt_futures.append(ckpt_executor.submit(run))

    # the prefetch worker annotates the window it uploads (its annotators'
    # host syncs then wait only for the side stream), except under
    # loop-back, where the overlap slots wait for the window before
    annotates = bool(cfg.controlnets) and hasattr(pipeline, "prepare_cond_images")
    pre_annotate = annotates and not cfg.loop_back_frames

    def prefetch(tail: list, epoch: int):
        new = read_n(window - len(tail))
        if not new:
            return new, None

        def annotate(frames):
            with timers.phase("annotate"):
                return pipeline.prepare_cond_images(frames, epoch)

        return new, stager.upload(np.stack(tail + new), annotate if pre_annotate else None)

    def upscaled(frames: torch.Tensor) -> torch.Tensor:
        if upscaler is None:
            return frames
        with timers.phase("upscale"):
            return upscaler.upscale_batch_device(frames)

    def write_frames(frames, upscale: bool) -> None:
        """`_write_rgb`, through the upscaler first when `upscale`."""
        t = torch.as_tensor(frames)
        _write_rgb(frame_sink, sink_pix_fmt, device, upscaled(t.to(device)) if upscale else t)

    windows_run = 0
    source_exhausted = stop_requested = False
    pending_emit = None  # (readback, was_yuv, start_idx, input frames for the dump)

    def flush_emit():
        nonlocal pending_emit
        if pending_emit is None:
            return
        readback, was_yuv, start_idx, dump_inputs = pending_emit
        pending_emit = None
        with timers.phase("emit"):
            packed = readback.numpy()
            if was_yuv:
                for fr in packed:
                    frame_sink.write(fr)
            else:
                write_frames(packed, upscale=False)
        if cfg.save_frames:
            _dump_frames(cfg, seed, out_dir, start_idx, packed, dump_inputs)

    with maybe_trace(cfg.trace_dir):
        while True:
            if max_windows is not None and windows_run >= max_windows:
                break
            overlap_inputs = list(state.overlap_input_frames)
            staged_input = cond_images = None
            if pending_prefetch is not None:
                new_frames, upload = pending_prefetch.result()
                pending_prefetch = None
                if upload is not None:
                    staged_input, cond_images = stager.claim(*upload)
            elif frame_source is not None:
                new_frames = read_n(window - len(overlap_inputs))
            else:
                new_frames = []
            if frame_source is not None and not new_frames:
                source_exhausted = True
                break
            if frame_source is None and max_windows is None and windows_run >= 1:
                # txt2vid: overlap-stitched windows up to total_frames; the
                # pending tail overlap flushes after the loop and counts
                if frames_written + state.overlap_length >= max(
                        int(cfg.total_frames), cfg.frame_count):
                    break
            # after the natural-completion breaks: a stop landing during the
            # last window is a completed run
            if should_stop is not None and should_stop():
                stop_requested = True
                break
            consumed += len(new_frames)

            batch = overlap_inputs + new_frames
            overlaps = state.overlap_length
            if overlaps and cfg.loop_back_frames:
                # the previous window's generated overlap frames in the overlap slots
                prev = state.overlap_frames
                batch[:overlaps] = list(_host(prev))
                if staged_input is not None:
                    staged_input = staged_input.clone()  # the stager's buffer stays as it is
                    staged_input[:overlaps] = torch.as_tensor(prev).to(staged_input.device)
            input_frames = staged_input if staged_input is not None else (
                np.stack(batch) if batch else None)
            strength = cfg.overlap_strength if overlaps else cfg.strength
            last_out = state.last_output_frames

            # start the next window's read and upload before this window runs,
            # unless `max_windows` ends the run with this one
            if executor is not None and (max_windows is None or windows_run + 1 < max_windows):
                tail = list(batch[-overlap_length:]) if overlap_length > 0 else []
                pending_prefetch = executor.submit(prefetch, tail, state.epoch + 1)

            if annotates and cond_images is None and input_frames is not None:
                with timers.phase("annotate"):
                    cond_images = pipeline.prepare_cond_images(input_frames, state.epoch)
            cond_kw = {} if cond_images is None else {"cond_images": cond_images}
            with timers.phase("animate_window"):
                frames_dev = pipeline.animate(
                    input_frames, last_out, overlaps=overlaps, strength=strength,
                    seed=seed, epoch=state.epoch, **cond_kw,
                )
                if initial_pass:
                    # again, anchored on its own tail at `overlap_strength`;
                    # its first frame becomes the color-match anchor
                    initial_pass = False
                    state.last_output_frame = frames_dev[0]
                    anchors = frames_dev[-max(overlap_length, 1):]
                    frames_dev = pipeline.animate(
                        input_frames, anchors, overlaps=int(anchors.shape[0]),
                        strength=cfg.overlap_strength, seed=seed, epoch=state.epoch, **cond_kw,
                    )

            # the previous window's emit, while this window computes
            flush_emit()

            # checkpoint after the flush and before this window's state
            # updates: it covers exactly the frames on the sink
            if (ckpt_executor is not None and state.epoch > 0
                    and state.epoch % cfg.checkpoint_interval == 0):
                submit_checkpoint(_snapshot_state(
                    state, consumed - len(new_frames), frames_written, segment))

            F_cur = int(frames_dev.shape[0])
            emit = F_cur - min(overlap_length, F_cur) if overlap_length > 0 else F_cur
            to_yuv = sink_pix_fmt == "yuv420p" and not cfg.save_frames
            with timers.phase("stitch"):
                anchor = (torch.as_tensor(state.last_output_frame).to(frames_dev.device)
                          if state.last_output_frame is not None else None)
                prev_overlap = (torch.as_tensor(state.overlap_frames).to(frames_dev.device)
                                if overlaps else None)
                packed, new_anchor, last_out_dev, tail_dev = stitch_window(
                    frames_dev, anchor, prev_overlap,
                    overlap_length=overlap_length, to_yuv=to_yuv and upscaler is None,
                    emit=emit,
                )
            if upscaler is not None:
                packed = upscaled(packed)
                if to_yuv:
                    packed = rgb_to_yuv420(packed)
            # the readback starts now (into pinned memory) and is read at the next flush
            with timers.phase("readback"):
                readback = _Readback(packed)
            state.last_output_frame = new_anchor
            if overlap_length > 0:
                state.last_output_frames = last_out_dev
                state.overlap_frames = tail_dev
                state.overlap_input_frames = batch[-overlap_length:]

            frames_written += emit
            pending_emit = (readback, to_yuv, frames_written - emit, list(batch[:emit]))
            state.epoch += 1
            windows_run += 1
            if progress is not None:
                # this window's emit is still pending: report the sink's count
                progress({
                    "windows": windows_run,
                    "frames_written": frames_written - emit,
                    "frames_generated": frames_written,
                })

        flush_emit()
        interrupted = stop_requested or (
            max_windows is not None and windows_run >= max_windows and not source_exhausted)
        # resumable only if a checkpoint records where to restart; otherwise
        # an interrupted run emits its tail
        resumable = interrupted and ckpt_executor is not None
        if resumable:
            submit_checkpoint(_snapshot_state(state, consumed, frames_written, segment))
        # the tail overlap, except on a resumable run: the resumed first window
        # re-emits those positions blended
        if not resumable and state.overlap_frames is not None and state.overlap_length:
            write_frames(state.overlap_frames, upscale=True)
            frames_written += state.overlap_length
        if progress is not None and windows_run:
            progress({"windows": windows_run, "frames_written": frames_written,
                      "frames_generated": frames_written})

    if executor is not None:
        executor.shutdown(wait=True)
    if ckpt_executor is not None:
        ckpt_executor.shutdown(wait=True)
        errs = [f.exception() for f in ckpt_futures if f.exception() is not None]
        if errs and resumable and ckpt_futures[-1].exception() is not None:
            raise RuntimeError(
                "final resume checkpoint failed to save; the interrupted run "
                "cannot be resumed"
            ) from ckpt_futures[-1].exception()
        for e in errs:
            print(f"WARNING: checkpoint save failed: {e!r}", file=sys.stderr)
    if not interrupted:
        # a completed run leaves nothing to resume: clear a stale state file
        (out_dir / STATE_FILE).unlink(missing_ok=True)
    return {"frames_written": frames_written, "seed": seed, "windows": windows_run,
            "canceled": stop_requested}


def _write_rgb(frame_sink, sink_pix_fmt: str, device, frames) -> None:
    """Write (N, H, W, 3) uint8 frames (device or host) to the sink, as I420
    rows when the sink takes yuv420p."""
    t = torch.as_tensor(frames)
    if sink_pix_fmt == "yuv420p":
        t = rgb_to_yuv420(t.to(device))
    for fr in _host(t):
        frame_sink.write(fr)


def _check_segments(cfg: RunConfig, has_input: bool) -> None:
    """The settings a segment-parallel run refuses, before any file opens:
    ValueError for `resume`, `save_frames`, no input frames (txt2vid windows
    depend on the window before) and `overlap_length` >= `frame_count`."""
    if cfg.resume:
        raise ValueError("resume is not supported with parallel_segments: a segment-parallel "
                         "run writes no checkpoint (run without parallel_segments to resume)")
    if cfg.save_frames:
        raise ValueError("save_frames is not supported with parallel_segments (its dumps "
                         "number one sequential stream)")
    if not has_input:
        raise ValueError("parallel_segments needs input frames: txt2vid windows each depend "
                         "on the window before")
    if cfg.frame_count - cfg.overlap_length <= 0 and cfg.overlap_length > 0:
        raise ValueError(f"parallel_segments requires overlap_length < frame_count (got "
                         f"overlap_length={cfg.overlap_length}, "
                         f"frame_count={cfg.frame_count})")


def _run_segments(cfg, pipeline, upscaler, device, frame_source, frame_sink, sink_pix_fmt,
                  seed, timers, cleanup, max_windows, progress, should_stop) -> dict:
    """The segment-parallel loop of `vid2vid` (the JAX `_run_segments`):
    `max_windows` bounds the windows of each segment without moving the
    segment boundaries. Threads it starts are shut down through `cleanup`."""
    S = int(cfg.parallel_segments)
    F, ov = cfg.frame_count, cfg.overlap_length
    novel = F - ov if ov > 0 else F

    # drain the source and lay the segments out
    frames = []
    with timers.phase("read_input"):
        while (f := frame_source.read()) is not None:
            frames.append(f)
    T = len(frames)
    if T == 0:
        return {"frames_written": 0, "seed": seed, "windows": 0, "segments": S,
                "canceled": False}
    per_seg = -(-T // S)
    k = 1 if per_seg <= F else 1 + -(-(per_seg - F) // novel)
    # the boundaries come from the whole input; max_windows bounds k after
    seg_len = F + (k - 1) * novel
    arr = np.stack(frames)
    del frames
    if S * seg_len > T:
        arr = np.concatenate([arr, np.repeat(arr[-1:], S * seg_len - T, axis=0)])
    segs = arr.reshape(S, seg_len, *arr.shape[1:])
    if max_windows is not None:
        k = min(k, max_windows)

    to_yuv = sink_pix_fmt == "yuv420p" and upscaler is None
    emit = F - min(ov, F) if ov > 0 else F

    # window w+1 is uploaded (and annotated) on the side stream while w runs
    stager = _Stager(device)
    executor = pending = None
    if cfg.overlap_host_work:
        executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="seg-prefetch")
        cleanup.callback(executor.shutdown, wait=True)
    annotates = bool(cfg.controlnets) and hasattr(pipeline, "prepare_cond_images")
    pre_annotate = annotates and not cfg.loop_back_frames

    def prep(w: int):
        def annotate(batch):
            with timers.phase("annotate_prefetch"):
                return pipeline.prepare_cond_images(batch, w)

        batch = np.ascontiguousarray(segs[:, w * novel: w * novel + F])
        return stager.upload(batch, annotate if pre_annotate else None)

    seg_buffers: list[list] = [[] for _ in range(S)]
    overlap_out = last_out = anchor = None  # (S, ov, ...), (S, ov, ...), (S, H, W, 3)
    pending_readback = None
    initial_pass = cfg.use_ipadapter and cfg.do_initial_generation

    def fetch_emit():
        nonlocal pending_readback
        if pending_readback is None:
            return
        readback, pending_readback = pending_readback, None
        with timers.phase("emit_buffer"):
            packed = readback.numpy()
            for s in range(S):
                seg_buffers[s].append(packed[s])

    with maybe_trace(cfg.trace_dir):
        for w in range(k):
            if should_stop is not None and should_stop():
                # all or nothing: the sink is written after the last window
                if pending is not None:
                    pending.result()
                if progress is not None:
                    progress({"windows": w, "segments": S, "frames_generated": 0})
                return {"frames_written": 0, "seed": seed, "windows": w, "segments": S,
                        "canceled": True}
            if pending is not None:
                upload, pending = pending.result(), None
            else:
                upload = prep(w)
            staged, cond = stager.claim(*upload)
            if w > 0 and ov > 0 and cfg.loop_back_frames:
                # each segment's generated overlap frames in its overlap slots
                staged = staged.clone()  # the stager's buffer stays as it is
                staged[:, :ov] = overlap_out.to(staged.device)
            if executor is not None and w + 1 < k:
                pending = executor.submit(prep, w + 1)

            overlaps = ov if w > 0 else 0
            strength = cfg.overlap_strength if w > 0 else cfg.strength
            cond_kw = {} if cond is None else {"cond_images": cond}
            with timers.phase("animate_window"):
                out = pipeline.animate(staged, last_out, overlaps=overlaps, strength=strength,
                                       seed=seed, epoch=w, segments=S, **cond_kw)
                if initial_pass:
                    # again, each segment anchored on its own tail; the first
                    # pass's first frames are window 0's color-match anchors
                    initial_pass = False
                    anchor = out[:, 0]
                    anchors = out[:, -ov:] if ov > 0 else out[:, -1:]
                    out = pipeline.animate(staged, anchors, overlaps=int(anchors.shape[1]),
                                           strength=cfg.overlap_strength, seed=seed, epoch=w,
                                           segments=S, **cond_kw)

            # the previous window's emit, read back while this window computes
            fetch_emit()

            with timers.phase("stitch"):
                packed, anchor, last_out, overlap_out = stitch_window_batch(
                    out, anchor, overlap_out if w > 0 else None, overlap_length=ov,
                    to_yuv=to_yuv, emit=emit)
            pending_readback = _Readback(packed)
            if progress is not None:
                progress({"windows": w + 1, "segments": S,
                          "frames_generated": S * (F + w * novel)})

        fetch_emit()
        if ov > 0 and overlap_out is not None:
            # each segment's tail overlap, generated and not yet emitted
            tail = overlap_out
            if to_yuv:
                tail = rgb_to_yuv420(tail.reshape(-1, *tail.shape[2:])).reshape(S, ov, -1)
            pending_readback = _Readback(tail)
            fetch_emit()

    # segment 0's frames first, each segment's pad trimmed
    frames_written = 0
    with timers.phase("upscale_and_emit"):
        for s in range(S):
            real_len = max(0, min(seg_len, T - s * seg_len))
            if real_len == 0:
                break  # the trailing segments are pure pad
            out_frames = np.concatenate(seg_buffers[s])
            seg_buffers[s] = None
            budget = min(len(out_frames), real_len)
            out_frames = out_frames[:budget]
            if to_yuv:
                for fr in out_frames:
                    frame_sink.write(fr)
            elif upscaler is not None:
                # F frames an upscale, as the sequential loop stages a window
                for i in range(0, budget, F):
                    _write_rgb(frame_sink, sink_pix_fmt, device, upscaler.upscale_batch_device(
                        torch.from_numpy(out_frames[i:i + F]).to(device)))
            else:
                _write_rgb(frame_sink, sink_pix_fmt, device, out_frames)
            frames_written += budget

    if executor is not None:
        executor.shutdown(wait=True)
    return {"frames_written": frames_written, "seed": seed, "windows": k, "segments": S,
            "canceled": False}


def _dump_frames(cfg: RunConfig, seed: int, out_dir: Path, start_idx: int, out_frames,
                 in_frames) -> None:
    """save_frames: output and input PNGs, numbered from 1, and info.json
    (the config with the seed)."""
    from PIL import Image

    fdir, fdir_in = out_dir / "vid2vid_frames", out_dir / "vid2vid_input_frames"
    fdir.mkdir(exist_ok=True)
    fdir_in.mkdir(exist_ok=True)
    info = out_dir / "info.json"
    if not info.exists():
        snap = dataclasses.asdict(cfg)
        snap["seed"] = seed
        info.write_text(json.dumps(snap, indent=2, default=str))
    for i, frame in enumerate(out_frames):
        Image.fromarray(np.asarray(frame, np.uint8)).save(fdir / f"{start_idx + i + 1:04d}.png")
    for i, frame in enumerate(in_frames):
        Image.fromarray(np.asarray(frame, np.uint8)).save(fdir_in / f"{start_idx + i + 1:04d}.png")
