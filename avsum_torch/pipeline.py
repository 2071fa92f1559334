"""End-to-end summarize: decode -> shots -> features -> scores -> summary.

Counterpart of ``avsum_tpu/pipeline.py::AVPipeline.summarize`` on the path
the JAX package takes for a native Y4M reader with ``visual.sample_fps >
0`` (``_begin_video`` -> ``_finish_prep`` -> ``_finish_video``, then
``_score_summary_impl`` and ``_select_from_scores``), run synchronously:

1. frames sampled uniformly every round(fps / sample_fps) frames, read as
   YUV420 planes (resized on the host to ``visual.ship_size`` when the
   source is larger) and embedded on the device;
2. host C++ content scores -> cuts -> shot boundaries;
3. each sampled frame joins the shot that contains it, at most
   ``max_frames_per_shot`` per shot, and shots are mean-pooled on the
   device; a shot that caught no sample embeds its start frame;
4. audio streams for the whole waveform, pooled on each shot's samples;
5. the scorer over the shot sequence (padded to a multiple of 32), then
   the knapsack under the summary budget.

The JAX package's host threads, cross-video overlap, speculative
device-resident scoring, frame dedup and packed-plane shipping are not
ported; none of them changes the result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from avsum_torch.audio.frontend import AudioFrontend
from avsum_torch.io.video import audio_path_for, open_video
from avsum_torch.io.wav import load_audio_mono_16k_ship
from avsum_torch.summary.knapsack import select_summary
from avsum_torch.temporal.shots import (
    ContentDetectorConfig,
    boundaries_from_cuts,
    cuts_from_scores,
    refined_content_scores,
)
from avsum_torch.train.config import Config
from avsum_torch.vision.backbone import VisualFrontend

log = logging.getLogger("avsum_torch.pipeline")

SCORER_PAD = 32  # shot axis padded to a multiple of this


@dataclasses.dataclass
class ProcessedVideo:
    video_id: str
    visual: np.ndarray  # [S, 4096]
    audio: np.ndarray  # [S, 296]
    boundaries: np.ndarray  # [S, 2] frames
    fps: float
    n_frames: int


class AVPipeline:
    """Summarize one video at a time on ``device``.

    ``stage_seconds`` holds the host-clock seconds of each stage of the
    last video (device work synchronized at each stage's end)."""

    def __init__(self, config: Config, visual: VisualFrontend,
                 audio: AudioFrontend,
                 detector: Optional[ContentDetectorConfig] = None):
        self.config = config
        self.visual = visual
        self.audio = audio
        self.device = visual.device
        self.detector = detector or ContentDetectorConfig()
        self.stage_seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def _stage(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stage_seconds[name] = time.perf_counter() - t0

    # ------------------------------------------------------------------
    # host helpers (copies of the JAX pipeline's, which imports jax)
    # ------------------------------------------------------------------

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
        cfg = self.config
        if cfg.visual.sample_fps <= 0:
            raise ValueError("visual.sample_fps must be > 0: the "
                             "frame_stride sampling path is not ported")
        reader = open_video(video_path)
        try:
            if not (hasattr(reader, "content_scores")
                    and hasattr(reader, "read_yuv420")):
                raise RuntimeError(
                    f"{video_path!r} did not open with the native decoder "
                    "(native/build/libavsumio.so; avsum_torch.build."
                    "ensure_native_io builds it): shot detection needs its "
                    "content_scores")
            return self._process(reader, video_path)
        finally:
            reader.close()

    def _process(self, reader, video_path: str) -> ProcessedVideo:
        cfg = self.config
        self.stage_seconds = {}
        fps, n_frames = reader.fps, reader.n_frames
        stride = max(1, round(fps / cfg.visual.sample_fps))
        frame_idx = np.arange(0, n_frames, stride, dtype=np.int64)
        bs = self.visual.batch_size

        with self._stage("visual_embed"):
            feats = [self.visual.frame_features_yuv(
                *self._read_yuv(reader, frame_idx[i:i + bs]))
                for i in range(0, len(frame_idx), bs)]
            feats = (torch.cat(feats) if feats else
                     torch.zeros(0, cfg.visual.feature_dim, device=self.device))

        with self._stage("shot_detect"):
            scale = max(1, reader.width // 256)
            scores = refined_content_scores(reader, scale,
                                            self.detector.threshold)
            cuts = cuts_from_scores(scores, self.detector.threshold,
                                    self.detector.min_scene_len)
            boundaries = boundaries_from_cuts(cuts, n_frames)
            if len(boundaries) == 0:
                boundaries = np.array([[0, n_frames]], np.int64)

        with self._stage("audio_features"):
            waveform = self._load_audio(video_path, n_frames / fps)
            audio_full = self.audio.full_features(waveform)

        with self._stage("visual_pool"):
            starts = boundaries[:, 0]
            shot_ids = np.searchsorted(starts, frame_idx, side="right") - 1
            first_of_shot = np.searchsorted(shot_ids,
                                            np.arange(len(boundaries)))
            rank = np.arange(len(frame_idx)) - first_of_shot[shot_ids]
            keep = rank < cfg.visual.max_frames_per_shot
            pooled, counts = self.visual.pool(feats, shot_ids, keep,
                                              len(boundaries))
            visual = pooled.cpu().numpy()
            # shots shorter than the sampling stride caught no sample:
            # embed their start frames
            missing = counts.cpu().numpy() <= 0
            if missing.any():
                extra = self._read_yuv(reader, boundaries[missing, 0])
                visual[missing] = self.visual.frame_features_yuv(*extra).cpu().numpy()

        with self._stage("audio_pool"):
            sample_bounds = (boundaries.astype(np.float64) / fps
                             * cfg.audio.sample_rate)
            audio = self.audio.pool(audio_full, sample_bounds).cpu().numpy()

        return ProcessedVideo(
            video_id=os.path.splitext(os.path.basename(video_path))[0],
            visual=visual.astype(np.float32),
            audio=audio.astype(np.float32),
            boundaries=np.asarray(boundaries, np.int64),
            fps=fps,
            n_frames=n_frames,
        )

    # ------------------------------------------------------------------
    # scoring + selection
    # ------------------------------------------------------------------

    def summarize(self, video_path: str, model: Optional[torch.nn.Module] = None,
                  budget_fraction: Optional[float] = None) -> Dict:
        """Raw video -> shot scores -> knapsack summary segments. Without
        a ``model`` every shot scores 1 (longest-fit summary)."""
        p = self.process_video(video_path)
        with self._stage("score"):
            scores = self.score(p, model)
        with self._stage("select"):
            return self._select_from_scores(p, scores, budget_fraction)

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

    def score(self, p: ProcessedVideo,
              model: Optional[torch.nn.Module]) -> np.ndarray:
        if model is None:
            return np.ones(len(p.visual), np.float32)
        s, visual, audio, mask = self.pad_scorer_inputs(p)
        with torch.inference_mode():
            out = model(*(torch.from_numpy(a).to(self.device)
                          for a in (visual, audio, mask)))
        return out[0, :s].float().cpu().numpy()

    def _select_from_scores(self, p: ProcessedVideo, scores: np.ndarray,
                            budget_fraction: Optional[float]) -> Dict:
        budget = (self.config.summary.budget_fraction
                  if budget_fraction is None else budget_fraction)
        boundaries = p.boundaries
        selected, segments = select_summary(scores, boundaries, p.n_frames,
                                            budget)
        if len(segments) == 0 and len(boundaries) > 0:
            # every shot exceeds the budget: the best shot, truncated
            best = int(np.argmax(scores))
            start = int(boundaries[best, 0])
            end = min(int(boundaries[best, 1]),
                      start + max(int(budget * p.n_frames), 1))
            selected = np.zeros(len(boundaries), bool)
            selected[best] = True
            segments = np.array([[start, end]], np.int64)
        return {
            "video_id": p.video_id,
            "scores": scores,
            "boundaries": boundaries,
            "selected": selected,
            "segments": segments,
            "fps": p.fps,
            "n_frames": p.n_frames,
        }
