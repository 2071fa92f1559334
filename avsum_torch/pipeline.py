"""End-to-end pipeline: decode -> shots -> features -> scores -> summary,
and the dataset sweep into the feature cache.

Counterpart of ``avsum_tpu/pipeline.py::AVPipeline``. Each video takes one
of the JAX package's two paths, by :meth:`AVPipeline._fast_capable`:

The fast path, for a native reader with ``visual.sample_fps > 0``, split
into a begin (``_begin_video``) and a finish, so that a caller can begin
video i+1 while video i's device work is still queued:

1. begin: a detect thread (host C++ content scores, which release the
   GIL) and a wav thread start; meanwhile the dispatch loop reads the
   frames sampled every round(fps / sample_fps) frames as YUV420 planes
   (resized on the host to ``visual.ship_size`` when the source is
   larger, straight into the one-buffer packed layout), uploads them
   through pinned buffers and enqueues their embedding on the device.
   With ``visual.dedup_threshold > 0`` a frame is embedded only when its
   mean |Δluma| against the last embedded frame reaches the threshold;
   the others reuse their run's embedding (``run_ids``), which changes
   the features as the JAX package's dedup does;
2. finish (``_finish_prep``): the threads joined, the audio streams
   enqueued for the whole waveform, the scores turned into cuts and shot
   boundaries; each sampled frame joins the shot that contains it, at
   most ``max_frames_per_shot`` per shot;
3. pooling on the device, into a 64-multiple shot bucket. The
   materializing finish (``_finish_video``) reads the features back (a
   shot that caught no sample embeds its start frame); the device-
   resident summarize (``_finish_summary_fast``) feeds the bucket's first
   rows, padded to a multiple of 32 as the materializing path pads them,
   to the scorer on the device, dispatched before the host reads the
   counts, and
   reads back only the counts and the [S] scores, taking the
   materializing road in the rare case of a shot with no sample;
4. the knapsack under the summary budget (on the device at 5e7 DP cells
   or more).

The classic path (``_process_video_classic``), for every other reader (the
pure-NumPy Y4M reader, MJPEG MP4, OpenCV) and for ``visual.sample_fps <=
0``: shots first, from the native reader's C++ scores where it has them,
else from the device detector over frames streamed at the detection
downscale; then every ``frame_stride``-th frame of each shot (or the
``sample_fps`` stride), at most ``max_frames_per_shot``, embedded and
mean-pooled per shot; then the audio per shot. Its begin does nothing
but open the reader.

``summarize`` is ``summarize_begin(...)()``; ``preprocess_dataset``
sweeps a directory into a ``FeatureCache`` with video i+1 begun before
video i is finished.

The stages are :func:`~avsum_torch.utils.profiling.annotate` spans under
the JAX package's names (``avsum.detect_thread``, ``avsum.visual_dispatch``,
``avsum.audio_dispatch``, ``avsum.shot_detect_host``, ``avsum.visual_pool``,
``avsum.audio_pool``, ``avsum.score_select``; the classic path's
``avsum.shot_detect``, ``avsum.visual_features``,
``avsum.audio_features``), which add no wait for the device;
``stage_seconds`` keeps its own keys, each also the span ``avsum.<key>``
where the JAX package names none. Inside them, the port's own spans:
``avsum.frame_read`` (the reader's call in the dispatch loop),
``avsum.frame_upload`` and ``avsum.embed_enqueue`` (the pinned upload
and the backbones' launches, ``vision/backbone.py``),
``avsum.detect_join`` (the finisher's join of the detect thread),
``avsum.audio_embed`` (K1, the spectra and VGGish enqueued),
``avsum.scorer_launch`` (the scorer's launches, without its readback)
and ``avsum.device_wait`` (every place the caller blocks on the device:
a pinned slot's event, the counts' copy, the scores' readback).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
from torch import nn

from avsum_torch.audio.frontend import AudioFrontend
from avsum_torch.data.cache import FeatureCache, config_fingerprint
from avsum_torch.io.video import audio_path_for, open_video
from avsum_torch.io.wav import load_audio_mono_16k_ship
from avsum_torch.summary.knapsack import select_summary
from avsum_torch.temporal.shots import (
    ContentDetectorConfig,
    boundaries_from_cuts,
    cuts_from_scores,
    detect_shots_streaming,
    refined_content_scores,
)
from avsum_torch.train.config import Config
from avsum_torch.utils.profiling import annotate
from avsum_torch.utils.transfer import to_device
from avsum_torch.vision.backbone import VisualFrontend, sample_shot_frames

log = logging.getLogger("avsum_torch.pipeline")

SCORER_PAD = 32  # the materializing path pads the shot axis to a multiple


@contextlib.contextmanager
def _clock(stages: Dict[str, float], name: str, span: Optional[str] = None):
    """Host-clock seconds of the block into ``stages[name]`` (the device
    is not waited for); the block is also the
    :func:`~avsum_torch.utils.profiling.annotate` span ``span``, by
    default ``avsum.<name>``."""
    t0 = time.perf_counter()
    with annotate(span or f"avsum.{name}"):
        yield
    stages[name] = time.perf_counter() - t0


def _dedup_select(flat, anchor, threshold):
    """Exact greedy dedup over one block of flattened luma frames (a copy
    of the JAX package's).

    Keeps frame j iff mean |Δluma| vs the LAST KEPT frame >= threshold
    (identical semantics to a per-frame scan). Vectorized with galloping
    doubling windows per anchor run, so total elementwise work stays
    within 2x one pass over the block whether keeps are sparse (long
    static runs: one window per run) or dense (every frame changes).

    Returns (kept indices list, new anchor or the incoming one).
    """
    n = flat.shape[0]
    keep = []
    j = 0
    while j < n:
        if anchor is None:
            keep.append(j)
            anchor = flat[j]
            j += 1
            continue
        base, w, hit = j, 4, -1
        while base < n:
            end = min(base + w, n)
            d = np.abs(flat[base:end] - anchor).mean(
                axis=1, dtype=np.float32
            )
            h = np.nonzero(d >= threshold)[0]
            if h.size:
                hit = base + int(h[0])
                break
            base, w = end, w * 2
        if hit < 0:
            break  # rest of the block pools into the current run
        keep.append(hit)
        anchor = flat[hit]
        j = hit + 1
    return keep, anchor


@dataclasses.dataclass
class ProcessedVideo:
    video_id: str
    visual: np.ndarray  # [S, 4096]
    audio: np.ndarray  # [S, 296]
    boundaries: np.ndarray  # [S, 2] frames
    fps: float
    n_frames: int


class AVPipeline:
    """Summarize or preprocess videos on ``device``.

    ``stage_seconds`` holds host-clock seconds of the last finished
    video; no stage waits for the device to be timed. The fast path's
    begin records visual_dispatch (the dispatch loop: reading, uploading
    and enqueueing), shot_detect and audio_load (the detect and wav
    threads' own seconds, overlapping the loop); its finish records prep
    (joining the threads, enqueueing the audio, the boundaries), then
    visual_pool and audio_pool when it materializes (each up to its
    features on the host), or pool (enqueueing both) and score (the
    scorer enqueued, the counts and the scores read back: the wait for
    the device lands here) on the device-resident summarize, and finish,
    from the finisher's start to its result. The classic path records
    shot_detect, visual_features and audio_features, each with its
    pooling. Summarize adds select (and score on the materializing
    road)."""

    def __init__(self, config: Config, visual: VisualFrontend,
                 audio: AudioFrontend,
                 detector: Optional[ContentDetectorConfig] = None):
        self.config = config
        self.visual = visual
        self.audio = audio
        self.device = visual.device
        self.detector = detector or ContentDetectorConfig()
        self.stage_seconds: Dict[str, float] = {}

    # ------------------------------------------------------------------
    # host helpers (copies of the JAX pipeline's, which imports jax)
    # ------------------------------------------------------------------

    @staticmethod
    def _stream_blocks(reader, block: int = 256) -> Iterator[np.ndarray]:
        if hasattr(reader, "iter_blocks"):  # native prefetched path
            for _, frames in reader.iter_blocks(block_frames=block):
                yield frames
        else:
            buf = []
            for frame in reader.iter_frames():
                buf.append(frame)
                if len(buf) == block:
                    yield np.stack(buf)
                    buf = []
            if buf:
                yield np.stack(buf)

    @staticmethod
    def _detect_downscale(width: int) -> int:
        """Integer subsampling for content scoring that keeps the scored
        width >= 256 px (PySceneDetect's ``compute_downscale_factor``)."""
        return max(1, width // 256)

    def _stream_scaled_blocks(self, reader, scale: int,
                              block: int = 512) -> Iterator[np.ndarray]:
        if scale > 1 and hasattr(reader, "read_frames_scaled"):
            for start in range(0, reader.n_frames, block):
                idx = range(start, min(start + block, reader.n_frames))
                yield reader.read_frames_scaled(idx, scale)
        else:
            yield from self._stream_blocks(reader, block)

    def _read_yuv(self, reader, idx):
        """YUV420 planes of frames ``idx``, host-resized to
        ``visual.ship_size`` when the source is larger."""
        ship = self.config.visual.ship_size
        if (ship and hasattr(reader, "read_yuv420_resized")
                and reader.width * reader.height > ship * ship):
            return reader.read_yuv420_resized(idx, ship, ship)
        return reader.read_yuv420(idx)

    def _load_audio(self, video_path: str, duration_s: float) -> np.ndarray:
        """Soundtrack: <stem>.wav sidecar, else the container's own track,
        else silence when ``audio.silence_fallback`` allows it."""
        wav_path = audio_path_for(video_path)
        if wav_path is not None:
            return load_audio_mono_16k_ship(wav_path)

        sr = self.config.audio.sample_rate
        silence = np.zeros(max(int(duration_s * sr), sr), np.float32)
        ext = os.path.splitext(video_path)[1].lower()
        if ext in (".mp4", ".mov", ".m4v"):
            from avsum_torch.io.mp4 import (
                Mp4NoAudioTrack,
                Mp4UnsupportedCodec,
                load_mp4_audio_mono_16k,
            )

            try:
                return load_mp4_audio_mono_16k(video_path)
            except Mp4NoAudioTrack:
                log.warning("%s has no audio track; using silence", video_path)
                return silence
            except Mp4UnsupportedCodec as e:
                got = self._container_audio(video_path)
                if got is not None:
                    return got
                if self.config.audio.silence_fallback:
                    log.warning("%s; using silence (audio.silence_fallback)", e)
                    return silence
                raise
        elif ext != ".y4m":
            got = self._container_audio(video_path, silence=silence)
            if got is not None:
                return got
        if self.config.audio.silence_fallback:
            log.warning("no paired audio for %s; using silence", video_path)
            return silence
        raise RuntimeError(
            f"no audio for {video_path!r}: add a <stem>.wav sidecar or set "
            "audio.silence_fallback=true to run video-only"
        )

    @staticmethod
    def _container_audio(video_path: str,
                         silence: Optional[np.ndarray] = None):
        from avsum_torch.io.ffaudio import (
            FFAudioError,
            FFNoAudioStream,
            ffmpeg_audio_available,
            load_audio_mono_16k_ff,
        )

        if not ffmpeg_audio_available():
            return None
        try:
            return load_audio_mono_16k_ff(video_path)
        except FFNoAudioStream:
            if silence is not None:
                log.warning("%s has no audio track; using silence", video_path)
                return silence
            return None
        except FFAudioError as e:
            log.warning("bundled-ffmpeg audio decode failed: %s", e)
            return None

    # ------------------------------------------------------------------
    # features
    # ------------------------------------------------------------------

    def process_video(self, video_path: str) -> ProcessedVideo:
        """Shot boundaries and per-shot [S, 4096] / [S, 296] features."""
        return self._begin_processed(video_path)()

    def _fast_capable(self, reader) -> bool:
        return (self.config.visual.sample_fps > 0
                and hasattr(reader, "content_scores")
                and hasattr(reader, "read_yuv420"))

    def _begin_processed(self, video_path: str, then=None, finish=None):
        """Open one video and begin it -> a zero-argument finisher giving
        ``then(ProcessedVideo)`` (default: the ``ProcessedVideo``). On the
        fast path the host threads and the device dispatch start now, and
        ``finish(state)``, where given, takes the place of the features'
        finish and ``then``; other readers are processed by the
        finisher."""
        then = then or (lambda p: p)
        reader = open_video(video_path)
        video_id = os.path.splitext(os.path.basename(video_path))[0]
        if self._fast_capable(reader):
            try:
                st = self._begin_video(reader, video_id)
            except BaseException:
                reader.close()  # _begin_video joined its own threads
                raise

            def _finish():
                try:
                    if finish is not None:
                        return finish(st)
                    p = self._finish_video(st)
                finally:
                    reader.close()
                return then(p)

            return _finish

        def _finish_sync():
            try:
                p = self._process_video_classic(reader, video_id)
            finally:
                reader.close()
            return then(p)

        return _finish_sync

    def _process_video_classic(self, reader, video_id: str) -> ProcessedVideo:
        """Shots first (the native reader's C++ scores, else the device
        detector over streamed frames), then the features of each shot's
        sampled frames, read whole."""
        cfg = self.config
        fps, n_frames = reader.fps, reader.n_frames
        stages: Dict[str, float] = {}
        with _clock(stages, "shot_detect", "avsum.shot_detect"):
            scale = self._detect_downscale(reader.width)
            if hasattr(reader, "content_scores"):
                scores = refined_content_scores(reader, scale,
                                                self.detector.threshold)
                cuts = cuts_from_scores(scores, self.detector.threshold,
                                        self.detector.min_scene_len)
                boundaries = boundaries_from_cuts(cuts, n_frames)
            else:
                boundaries, n_frames = detect_shots_streaming(
                    self._stream_scaled_blocks(reader, scale), self.detector,
                    self.device)
            if len(boundaries) == 0:
                boundaries = np.array([[0, n_frames]], np.int64)

        with _clock(stages, "visual_features", "avsum.visual_features"):
            if cfg.visual.sample_fps > 0:
                stride = max(1, round(fps / cfg.visual.sample_fps))
            else:
                stride = cfg.visual.frame_stride
            frame_idx, shot_ids = sample_shot_frames(
                boundaries, stride, cfg.visual.max_frames_per_shot)
            if hasattr(reader, "read_yuv420"):
                visual = self.visual.shot_features(
                    None, shot_ids, len(boundaries),
                    yuv=self._read_yuv(reader, frame_idx))
            else:
                visual = self.visual.shot_features(
                    reader.read_frames(frame_idx), shot_ids, len(boundaries))
            visual = visual.cpu().numpy()

        with _clock(stages, "audio_features", "avsum.audio_features"):
            waveform = self._load_audio(reader.path, n_frames / fps)
            audio = self.audio.shot_features(
                waveform, self._sample_bounds(boundaries, fps)).cpu().numpy()
        self.stage_seconds = stages
        return ProcessedVideo(
            video_id=video_id,
            visual=visual.astype(np.float32),
            audio=audio.astype(np.float32),
            boundaries=np.asarray(boundaries, np.int64),
            fps=fps,
            n_frames=n_frames,
        )

    def _begin_video(self, reader, video_id: str) -> Dict:
        """Start one video's host threads (detection, wav) and enqueue its
        visual embedding -> the in-flight state for the finishers. On a
        failure the threads are joined before this raises, since they read
        the reader the caller then closes."""
        fps, n_frames = reader.fps, reader.n_frames
        stride = max(1, round(fps / self.config.visual.sample_fps))
        frame_idx = np.arange(0, n_frames, stride, dtype=np.int64)
        scale = self._detect_downscale(reader.width)
        stages: Dict[str, float] = {}
        host_work: Dict = {}  # each thread writes its own keys

        def _detect():
            with _clock(stages, "shot_detect", "avsum.detect_thread"):
                try:
                    host_work["scores"] = refined_content_scores(
                        reader, scale, self.detector.threshold)
                except Exception as e:  # re-raised by _finish_prep
                    host_work["detect_error"] = e

        def _wav():
            with _clock(stages, "audio_load"):
                try:
                    host_work["waveform"] = self._load_audio(
                        reader.path, n_frames / fps)
                except Exception as e:  # re-raised by _finish_prep
                    host_work["wav_error"] = e

        det_thread = threading.Thread(target=_detect, name="avsum-detect")
        wav_thread = threading.Thread(target=_wav, name="avsum-wav")
        det_thread.start()
        wav_thread.start()
        try:
            with _clock(stages, "visual_dispatch", "avsum.visual_dispatch"):
                pending, run_ids = self._dispatch_visual(reader, frame_idx)
        except BaseException:
            det_thread.join()
            wav_thread.join()
            raise
        return {"reader": reader, "video_id": video_id, "fps": fps,
                "n_frames": n_frames, "frame_idx": frame_idx,
                "host_work": host_work, "det_thread": det_thread,
                "wav_thread": wav_thread, "pending": pending,
                "run_ids": run_ids, "stages": stages}

    def _dispatch_visual(self, reader, frame_idx: np.ndarray):
        """Read the sampled frames block by block and enqueue their
        embedding -> (pending [bucket, D] device tensors, run_ids or None).
        Host memory stays at about one block of planes."""
        bs = self.visual.batch_size
        pending = []
        ded = self.config.visual.dedup_threshold
        if ded > 0:
            # embed a frame only when its luma moved >= threshold against
            # the last embedded one; the others pool their run's embedding
            # (run_ids). Cuts exceed any sane threshold, so the shots stay.
            run_ids = np.empty(len(frame_idx), np.int32)
            n_unique = 0
            anchor = None
            bufs: list = []  # [(y, u, v)] kept-plane chunks
            cnt = 0

            def _flush(force=False):
                nonlocal bufs, cnt
                while cnt >= bs or (force and cnt > 0):
                    take = min(bs, cnt)
                    ycat = np.concatenate([b[0] for b in bufs])
                    ucat = np.concatenate([b[1] for b in bufs])
                    vcat = np.concatenate([b[2] for b in bufs])
                    block, _ = self.visual.dispatch_yuv(
                        ycat[:take], ucat[:take], vcat[:take])
                    pending.extend(block)
                    rest = (ycat[take:], ucat[take:], vcat[take:])
                    bufs = [rest] if rest[0].shape[0] else []
                    cnt -= take

            for i in range(0, len(frame_idx), bs):
                with annotate("avsum.frame_read"):
                    y, u, v = self._read_yuv(reader, frame_idx[i:i + bs])
                n = y.shape[0]
                flat = y.reshape(n, -1).astype(np.int16)
                keep, anchor = _dedup_select(flat, anchor, ded)
                karr = np.asarray(keep, np.int64)
                # run id = index of the kept frame this one pools into
                run_ids[i:i + n] = n_unique - 1 + np.searchsorted(
                    karr, np.arange(n), side="right")
                n_unique += len(keep)
                if len(keep):
                    bufs.append((y[karr], u[karr], v[karr]))
                    cnt += len(keep)
                    _flush()
            _flush(force=True)
            log.debug("dedup: %d/%d frames shipped", n_unique, len(frame_idx))
            return pending, run_ids

        ship = self.config.visual.ship_size
        packed = (ship and hasattr(reader, "read_yuv420_packed")
                  and reader.width * reader.height > ship * ship)
        for i in range(0, len(frame_idx), bs):
            idx = frame_idx[i:i + bs]
            if packed:
                # the C++ reader writes the resized planes straight into
                # the one-buffer layout, padded to the block's bucket
                with annotate("avsum.frame_read"):
                    buf = reader.read_yuv420_packed(
                        idx, ship, ship, self.visual.tail_bucket(len(idx)))
                pending.append(self.visual.dispatch_packed(buf, ship, ship))
            else:
                with annotate("avsum.frame_read"):
                    planes = self._read_yuv(reader, idx)
                block, _ = self.visual.dispatch_yuv(*planes)
                pending.extend(block)
        return pending, None

    def _finish_prep(self, st: Dict) -> Dict:
        """Join the host threads, enqueue the audio streams, turn the
        detection scores into shot boundaries and each sampled frame's
        shot and cap mask."""
        host_work = st["host_work"]
        with annotate("avsum.audio_dispatch"):
            st["wav_thread"].join()
            try:
                if "wav_error" in host_work:
                    raise host_work["wav_error"]
                with annotate("avsum.audio_embed"):
                    audio_full = self.audio.dispatch_full(
                        host_work["waveform"])
            except BaseException:
                # the detect thread reads the reader the caller then closes
                st["det_thread"].join()
                raise
        n_frames, frame_idx = st["n_frames"], st["frame_idx"]
        with annotate("avsum.shot_detect_host"):
            with annotate("avsum.detect_join"):
                st["det_thread"].join()
            if "detect_error" in host_work:
                raise host_work["detect_error"]
            cuts = cuts_from_scores(host_work["scores"],
                                    self.detector.threshold,
                                    self.detector.min_scene_len)
            boundaries = boundaries_from_cuts(cuts, n_frames)
            if len(boundaries) == 0:
                boundaries = np.array([[0, n_frames]], np.int64)

        shot_ids = np.searchsorted(boundaries[:, 0], frame_idx,
                                   side="right") - 1
        first_of_shot = np.searchsorted(shot_ids, np.arange(len(boundaries)))
        rank = np.arange(len(frame_idx)) - first_of_shot[shot_ids]
        keep = rank < self.config.visual.max_frames_per_shot
        return {"audio_full": audio_full, "boundaries": boundaries,
                "shot_ids": shot_ids, "keep": keep}

    def _sample_bounds(self, boundaries: np.ndarray, fps: float) -> np.ndarray:
        return (boundaries.astype(np.float64) / fps
                * self.config.audio.sample_rate)

    def _repair_missing(self, reader, visual: np.ndarray, boundaries,
                        missing: np.ndarray) -> None:
        """Shots shorter than the sampling stride caught no sample: embed
        their start frames into ``visual`` (the classic path's rule)."""
        extra = self._read_yuv(reader, boundaries[missing, 0])
        visual[missing] = self.visual.frame_features_yuv(*extra).cpu().numpy()

    def _finish_video(self, st: Dict) -> ProcessedVideo:
        t0 = time.perf_counter()
        stages = st["stages"]
        with _clock(stages, "prep"):
            c = self._finish_prep(st)
        boundaries = c["boundaries"]
        with _clock(stages, "visual_pool", "avsum.visual_pool"):
            visual, counts = self.visual.pool_on_device(
                st["pending"], len(st["frame_idx"]), c["shot_ids"],
                c["keep"], len(boundaries), run_ids=st["run_ids"])
            missing = counts <= 0
            if missing.any():
                self._repair_missing(st["reader"], visual, boundaries,
                                     missing)
        with _clock(stages, "audio_pool", "avsum.audio_pool"):
            audio = self.audio.pool(
                c["audio_full"],
                self._sample_bounds(boundaries, st["fps"])).cpu().numpy()
        stages["finish"] = time.perf_counter() - t0
        self.stage_seconds = stages
        return ProcessedVideo(
            video_id=st["video_id"],
            visual=visual.astype(np.float32),
            audio=audio.astype(np.float32),
            boundaries=np.asarray(boundaries, np.int64),
            fps=st["fps"],
            n_frames=st["n_frames"],
        )

    def _finish_summary_fast(self, st: Dict, model: nn.Module,
                             budget_fraction: Optional[float]) -> Dict:
        """Device-resident scoring: the pooled features stay on the device
        and feed the scorer there, padded to a multiple of 32; only the
        counts and the [S] scores come back. The scorer is dispatched
        before the counts are read, so their copy rides under its device
        time; a shot with no sample (rare) discards those scores and takes
        the materializing road."""
        t0 = time.perf_counter()
        stages = st["stages"]
        fps, n_frames = st["fps"], st["n_frames"]
        with _clock(stages, "prep"):
            c = self._finish_prep(st)
        boundaries = c["boundaries"]
        n_shots = len(boundaries)
        # the materializing path's padding (a multiple of 32), so that both
        # paths give the scorer the same S; the visual pool's 64-multiple
        # bucket is at least as long
        sp = max(SCORER_PAD, -(-n_shots // SCORER_PAD) * SCORER_PAD)
        with _clock(stages, "pool"):
            with annotate("avsum.visual_pool"):
                pooled, counts = self.visual.pool_on_device(
                    st["pending"], len(st["frame_idx"]), c["shot_ids"],
                    c["keep"], n_shots, run_ids=st["run_ids"],
                    return_device=True)
            with annotate("avsum.audio_pool"):
                audio = self.audio.pool(
                    c["audio_full"], self._sample_bounds(boundaries, fps),
                    s_bucket=sp, return_device=True)
        with annotate("avsum.score_select"):
            with _clock(stages, "score"):
                mask = np.zeros(sp, np.float32)
                mask[:n_shots] = 1.0
                with torch.inference_mode(), annotate("avsum.scorer_launch"):
                    scores = model(pooled[None, :sp], audio[None],
                                   to_device(mask, self.device)[None])[0]
                missing = counts.numpy()[:n_shots] <= 0
                if missing.any():
                    visual = pooled[:n_shots].cpu().numpy()
                    self._repair_missing(st["reader"], visual, boundaries,
                                         missing)
                    p = ProcessedVideo(
                        video_id=st["video_id"], visual=visual,
                        audio=audio[:n_shots].cpu().numpy(),
                        boundaries=np.asarray(boundaries, np.int64), fps=fps,
                        n_frames=n_frames)
                    self.stage_seconds = stages
                    return self._score_summary(p, model, budget_fraction)
                with annotate("avsum.device_wait"):
                    scores = scores[:n_shots].float().cpu().numpy()
            with _clock(stages, "select"):
                out = self._select_from_scores(st["video_id"], scores,
                                               boundaries, fps, n_frames,
                                               budget_fraction)
        stages["finish"] = time.perf_counter() - t0
        self.stage_seconds = stages
        return out

    # ------------------------------------------------------------------
    # the dataset sweep
    # ------------------------------------------------------------------

    def preprocess_dataset(self, input_dir: str, cache: FeatureCache,
                           extensions=(".y4m", ".mp4", ".mov", ".m4v")
                           ) -> List[str]:
        """Sweep ``input_dir`` into ``cache`` -> the ids now cached. Video
        i+1 is begun (host threads and device dispatch) before video i is
        finished. A video cached under this configuration's fingerprint is
        skipped and one cached under another is extracted again; a video
        that fails is logged and dropped, and the sweep goes on."""
        fp = config_fingerprint(self.config.visual, self.config.audio,
                                self.detector)
        done = []

        def _complete(video_id, finisher, t0):
            try:
                p = finisher()
                self._validate_dims(p)
                cache.put(p.video_id, p.visual, p.audio, p.boundaries, p.fps,
                          p.n_frames, fingerprint=fp)
            except Exception as e:  # noqa: BLE001 — per-item isolation
                cache.drop(video_id)
                log.error("failed %s: %s", video_id, e)
                return
            done.append(video_id)
            log.info("cached %s: %d shots, %d frames in %.3f s, stages %s",
                     video_id, len(p.boundaries), p.n_frames,
                     time.perf_counter() - t0,
                     {k: round(v, 4) for k, v in self.stage_seconds.items()})

        in_flight = None  # (video_id, finisher, begin time)
        for name in sorted(f for f in os.listdir(input_dir)
                           if f.lower().endswith(extensions)):
            video_id = os.path.splitext(name)[0]
            if cache.matches(video_id, fp):
                log.info("skip %s (cached)", video_id)
                done.append(video_id)
                continue
            if cache.has(video_id):
                log.info("re-extracting %s (feature config changed)",
                         video_id)
                cache.drop(video_id)
            t0 = time.perf_counter()
            try:
                finisher = self._begin_processed(os.path.join(input_dir,
                                                              name))
            except Exception as e:  # noqa: BLE001 — per-item isolation
                cache.drop(video_id)
                log.error("failed %s: %s", video_id, e)
                continue
            if in_flight is not None:
                _complete(*in_flight)
            in_flight = (video_id, finisher, t0)
        if in_flight is not None:
            _complete(*in_flight)
        return done

    def _validate_dims(self, p: ProcessedVideo) -> None:
        """At least one shot, and the configured feature widths."""
        if (len(p.visual) == 0
                or p.visual.shape[1] != self.config.visual.feature_dim
                or p.audio.shape[1] != self.config.audio.feature_dim):
            raise ValueError(
                f"invalid feature dims {p.visual.shape}/{p.audio.shape}")

    # ------------------------------------------------------------------
    # scoring + selection
    # ------------------------------------------------------------------

    def summarize(self, video_path: str, model=None,
                  budget_fraction: Optional[float] = None) -> Dict:
        """Raw video -> shot scores -> knapsack summary segments. ``model``
        is the scorer (an ``nn.Module``), an exported artifact
        (``serve.export.load_scorer``) or None, when every shot scores 1
        (longest-fit summary)."""
        return self.summarize_begin(video_path, model, budget_fraction)()

    def summarize_begin(self, video_path: str, model=None,
                        budget_fraction: Optional[float] = None):
        """Begin one video's summarize (host threads and device dispatch)
        -> a zero-argument finisher giving the summary dict, so that a
        caller can begin video i+1 before finishing video i. With an
        ``nn.Module`` scorer on the fast path the scoring stays on the
        device (:meth:`_finish_summary_fast`); artifacts and runs without
        a scorer take the materializing path."""
        fast = None
        if isinstance(model, nn.Module):
            def fast(st):
                return self._finish_summary_fast(st, model, budget_fraction)
        return self._begin_processed(
            video_path,
            lambda p: self._score_summary(p, model, budget_fraction), fast)

    @staticmethod
    def pad_scorer_inputs(p: ProcessedVideo):
        """Pad the shot axis to a multiple of 32 -> (s, visual, audio, mask)
        as [1, S_pad, *] float32 arrays."""
        s = len(p.visual)
        s_pad = max(SCORER_PAD, -(-s // SCORER_PAD) * SCORER_PAD)
        visual = np.zeros((1, s_pad, p.visual.shape[1]), np.float32)
        audio = np.zeros((1, s_pad, p.audio.shape[1]), np.float32)
        mask = np.zeros((1, s_pad), np.float32)
        visual[0, :s] = p.visual
        audio[0, :s] = p.audio
        mask[0, :s] = 1.0
        return s, visual, audio, mask

    def score(self, p: ProcessedVideo, model) -> np.ndarray:
        """[S] scores of a processed video: the scorer (an ``nn.Module``
        or an exported artifact) over the shot axis padded to a multiple
        of 32; all ones without one."""
        if model is None:
            return np.ones(len(p.visual), np.float32)
        s, visual, audio, mask = self.pad_scorer_inputs(p)
        if not isinstance(model, nn.Module):  # an artifact places its inputs
            return torch.as_tensor(model(visual, audio, mask))[0, :s].float(
            ).cpu().numpy()
        with torch.inference_mode(), annotate("avsum.scorer_launch"):
            out = model(*(to_device(a, self.device)
                          for a in (visual, audio, mask)))
        return out[0, :s].float().cpu().numpy()

    def _score_summary(self, p: ProcessedVideo, model,
                       budget_fraction: Optional[float]) -> Dict:
        stages = self.stage_seconds
        with annotate("avsum.score_select"):
            with _clock(stages, "score"):
                scores = self.score(p, model)
            with _clock(stages, "select"):
                return self._select_from_scores(
                    p.video_id, scores, p.boundaries, p.fps, p.n_frames,
                    budget_fraction)

    def _select_from_scores(self, video_id: str, scores: np.ndarray,
                            boundaries: np.ndarray, fps: float,
                            n_frames: int,
                            budget_fraction: Optional[float]) -> Dict:
        budget = (self.config.summary.budget_fraction
                  if budget_fraction is None else budget_fraction)
        selected, segments = select_summary(scores, boundaries, n_frames,
                                            budget, self.device)
        if len(segments) == 0 and len(boundaries) > 0:
            # every shot exceeds the budget: the best shot, truncated
            best = int(np.argmax(scores))
            start = int(boundaries[best, 0])
            end = min(int(boundaries[best, 1]),
                      start + max(int(budget * n_frames), 1))
            selected = np.zeros(len(boundaries), bool)
            selected[best] = True
            segments = np.array([[start, end]], np.int64)
        return {
            "video_id": video_id,
            "scores": scores,
            "boundaries": np.asarray(boundaries, np.int64),
            "selected": selected,
            "segments": segments,
            "fps": fps,
            "n_frames": n_frames,
        }
