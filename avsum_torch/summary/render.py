"""Render a summary to media: a copy of ``avsum_tpu/summary/render.py`` on
the port's ``io``.

Frames are copied segment by segment; the audio is cut at the same times
from the paired wav or, failing that, the container's own track (PCM
natively, AAC / MP3 / ... through the bundled ffmpeg libraries).

Output containers:

- ``y4m`` (default): <out>.y4m + <out>.wav, lossless, no dependency;
- ``mp4``: one <out>.mp4, MJPEG video plus AAC audio where the bundled
  encoder is available (a PCM track otherwise).
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from avsum_torch.io.video import audio_path_for, open_video
from avsum_torch.io.wav import read_wav, resample, to_mono, write_wav
from avsum_torch.io.y4m import write_y4m

log = logging.getLogger("avsum_torch.render")


def _source_audio(video_path: str) -> Optional[Tuple[np.ndarray, int]]:
    """(mono float32, rate) from the sidecar wav or the container."""
    wav_path = audio_path_for(video_path)
    if wav_path is not None:
        samples, rate = read_wav(wav_path)
        return to_mono(samples), rate
    ext = os.path.splitext(video_path)[1].lower()
    if ext == ".y4m":
        return None
    if ext in (".mp4", ".mov", ".m4v"):
        from avsum_torch.io.mp4 import Mp4Error, extract_audio

        try:
            samples, rate = extract_audio(video_path)
            return to_mono(samples), rate
        except Mp4Error:
            pass
    from avsum_torch.io.ffaudio import (
        FFAudioError,
        decode_audio,
        ffmpeg_audio_available,
    )

    if not ffmpeg_audio_available():
        return None
    try:
        samples, rate = decode_audio(video_path)
        return to_mono(samples), rate
    except FFAudioError:
        return None


def render_summary(video_path: str, segments: Sequence[Tuple[int, int]],
                   out_stem: str, max_frames: Optional[int] = None,
                   container: str = "y4m") -> Tuple[str, Optional[str]]:
    """Write the summary media for ``segments``: ``container='y4m'`` ->
    (<out>.y4m, <out>.wav or None); ``container='mp4'`` -> (<out>.mp4 with
    the audio muxed in, None)."""
    if container not in ("y4m", "mp4"):
        raise ValueError(f"unknown render container {container!r}")
    reader = open_video(video_path)
    try:
        fps = reader.fps
        frame_idx = np.concatenate(
            [np.arange(int(a), int(b)) for a, b in segments]
        ) if len(segments) else np.zeros(0, np.int64)
        if max_frames is not None:
            frame_idx = frame_idx[:max_frames]
        if frame_idx.size == 0:
            raise ValueError("empty summary: nothing to render")
        frames = reader.read_frames(frame_idx)
    finally:
        reader.close()

    audio = _source_audio(video_path)
    pieces = []
    if audio is not None:
        mono, rate = audio
        for a, b in segments:
            s0 = int(a / fps * rate)
            s1 = min(int(b / fps * rate), len(mono))
            pieces.append(mono[s0:s1])

    if container == "mp4":
        from avsum_torch.io.ffaudio import aac_encode_available
        from avsum_torch.io.mp4_mux import write_aac_mp4, write_mjpeg_mp4

        video_out = out_stem + ".mp4"
        if pieces:
            mono_cut = np.concatenate(pieces)
            if aac_encode_available():
                # AAC wants a standard rate; 16 kHz is the front-end's
                write_aac_mp4(video_out, resample(mono_cut, rate, 16000),
                              16000, frames=frames, fps=fps)
            else:
                write_mjpeg_mp4(video_out, frames, fps=fps, audio=mono_cut,
                                audio_rate=rate)
        else:
            write_mjpeg_mp4(video_out, frames, fps=fps)
        log.info("rendered %d frames (%.1fs) -> %s", len(frames),
                 len(frames) / fps, video_out)
        return video_out, None

    video_out = out_stem + ".y4m"
    write_y4m(video_out, frames, fps=fps)
    audio_out = None
    if pieces:
        audio_out = out_stem + ".wav"
        write_wav(audio_out, np.concatenate(pieces), rate)
    log.info("rendered %d frames (%.1fs) -> %s", len(frames),
             len(frames) / fps, video_out)
    return video_out, audio_out
