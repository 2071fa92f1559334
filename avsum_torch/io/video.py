"""VideoReader abstraction (the cv2.VideoCapture replacement).

Reference usage to replace (reference/features/extractors.py:307-309,
395-413): open, read fps / frame count, seek to a frame, read sequential
frames. ``open_video`` dispatches on extension:

- ``.y4m``  -> pure-NumPy reader (native C++ fast path if built)
- ``.mp4`` etc. -> native ISO-BMFF demuxer (MJPEG/PCM tracks), then
  OpenCV/libavcodec for compressed codecs (H.264/mp4v/...) when the
  ``opencv-python`` wheel is importable, then imageio; a clear error
  with transcode advice only when no backend can decode the codec

Paired audio convention: ``<stem>.wav`` next to the video file carries the
soundtrack (replaces the reference's in-container audio + pydub extract).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Protocol

import numpy as np

from avsum_torch.io.y4m import Y4MReader


class VideoReader(Protocol):
    width: int
    height: int
    fps: float
    n_frames: int

    def read_frame(self, index: int) -> np.ndarray: ...

    def read_frames(self, indices) -> np.ndarray: ...

    def iter_frames(self, start: int = 0, stop: Optional[int] = None) -> Iterator[np.ndarray]: ...

    def close(self) -> None: ...


class _ImageioReader:
    """Fallback for containers imageio can decode in this environment."""

    def __init__(self, path: str):
        import imageio.v3 as iio

        self._iio = iio
        self.path = path
        props = iio.improps(path, plugin=None)
        meta = iio.immeta(path)
        self.fps = float(meta.get("fps", 30.0))
        shape = props.shape  # (T, H, W, C) or (H, W, C)
        if len(shape) == 4:
            self.n_frames, self.height, self.width = shape[0], shape[1], shape[2]
        else:
            self.n_frames, self.height, self.width = 1, shape[0], shape[1]

    @staticmethod
    def _coerce_rgb(frame: np.ndarray) -> np.ndarray:
        """Force 3-channel RGB (grayscale/RGBA inputs happen in the wild —
        the reference coerced these too, extractors.py:407-411)."""
        if frame.ndim == 2:
            return np.repeat(frame[..., None], 3, axis=-1)
        if frame.shape[-1] == 1:
            return np.repeat(frame, 3, axis=-1)
        if frame.shape[-1] == 4:
            return frame[..., :3]
        return frame

    def read_frame(self, index: int) -> np.ndarray:
        return self._coerce_rgb(self._iio.imread(self.path, index=index))

    def read_frames(self, indices) -> np.ndarray:
        return np.stack([self.read_frame(int(i)) for i in indices])

    def iter_frames(self, start: int = 0, stop: Optional[int] = None):
        for i, frame in enumerate(self._iio.imiter(self.path)):
            if i < start:
                continue
            if stop is not None and i >= stop:
                return
            yield self._coerce_rgb(frame)

    def close(self):
        pass


def open_video(path: str, prefer_native: bool = True) -> VideoReader:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".y4m":
        if prefer_native:
            try:
                from avsum_torch.io.native import NativeY4MReader, native_available

                if native_available():
                    return NativeY4MReader(path)
            except Exception:
                pass
        return Y4MReader(path)
    if ext in (".mp4", ".mov", ".m4v"):
        from avsum_torch.io.mp4 import Mp4Error, Mp4UnsupportedCodec, Mp4VideoReader

        try:
            return Mp4VideoReader(path)
        except Mp4UnsupportedCodec:
            # compressed codec (H.264/HEVC/mp4v/...): OpenCV's libavcodec
            # decodes these when the wheel is present; only raise the
            # transcode advice when it is not
            reader = _try_cv2(path)
            if reader is not None:
                return reader
            raise
        except Mp4Error:
            pass  # no/odd video track: give cv2/imageio a chance below
    reader = _try_cv2(path)
    if reader is not None:
        return reader
    try:
        return _ImageioReader(path)
    except Exception as e:
        raise RuntimeError(
            f"cannot decode {path!r}: no decoder for {ext} in this environment "
            "(y4m and MJPEG mp4/mov are always supported; other codecs need "
            "OpenCV, an imageio/ffmpeg plugin, or a one-time transcode)"
        ) from e


def _try_cv2(path: str):
    from avsum_torch.io.cv2video import Cv2Reader, cv2_available

    if not cv2_available():
        return None
    try:
        return Cv2Reader(path)
    except Exception:
        return None


def audio_path_for(video_path: str) -> Optional[str]:
    """Paired-audio convention: <stem>.wav beside the video."""
    stem = os.path.splitext(video_path)[0]
    candidate = stem + ".wav"
    return candidate if os.path.exists(candidate) else None
