"""OpenCV-backed VideoReader for compressed containers.

The reference's entire decode substrate WAS ``cv2.VideoCapture``
(reference/features/extractors.py:307-309, 395-413). Here OpenCV
is the optional *last-resort* backend behind the native demuxer: the
Y4M/MJPEG/PCM paths never touch it, but containers carrying compressed
codecs (H.264/HEVC/mp4v/XVID/...) decode through libavcodec when the
``opencv-python`` wheel is importable, instead of raising transcode
advice.

Frames are returned **RGB** uint8 — the reference fed cv2's BGR straight
into ImageNet-RGB models (SURVEY §8.3); this rebuild resolves that bug
as RGB-everywhere, so the conversion happens here at the boundary.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


def cv2_available() -> bool:
    try:
        import cv2  # noqa: F401
    except Exception:
        return False
    return True


class Cv2Reader:
    """cv2.VideoCapture behind the VideoReader protocol (RGB frames).

    Sequential reads are free; random access seeks with
    ``CAP_PROP_POS_FRAMES`` (frame-accurate on ffmpeg builds, same
    mechanism the reference relied on, extractors.py:397).
    """

    def __init__(self, path: str):
        import cv2

        self._cv2 = cv2
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            cap.release()
            raise RuntimeError(f"cv2 cannot open {path!r}")
        self._cap = cap
        self.path = path
        self.fps = float(cap.get(cv2.CAP_PROP_FPS)) or 30.0
        self.width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.n_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if self.n_frames <= 0:
            # some streams don't carry a frame count; count one pass
            n = 0
            while cap.grab():
                n += 1
            self.n_frames = n
            cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
        # probe-decode one frame: VideoCapture "opens" containers whose
        # payload its codecs cannot actually decode (e.g. a mislabeled
        # track); fail here so open_video can surface better advice
        ok, _ = cap.read()
        if not ok:
            cap.release()
            raise RuntimeError(f"cv2 opened but cannot decode {path!r}")
        cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
        self._pos = 0

    def _coerce_rgb(self, frame: np.ndarray) -> np.ndarray:
        cv2 = self._cv2
        if frame.ndim == 2:
            return cv2.cvtColor(frame, cv2.COLOR_GRAY2RGB)
        if frame.shape[-1] == 4:
            return cv2.cvtColor(frame, cv2.COLOR_BGRA2RGB)
        return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

    def _read_at(self, index: int) -> np.ndarray:
        if index < 0 or index >= self.n_frames:
            raise IndexError(f"frame {index} out of range [0, {self.n_frames})")
        if index != self._pos:
            self._cap.set(self._cv2.CAP_PROP_POS_FRAMES, index)
            self._pos = index
        ok, frame = self._cap.read()
        if not ok:
            raise IOError(f"cv2 failed to decode frame {index} of {self.path!r}")
        self._pos = index + 1
        return self._coerce_rgb(frame)

    def read_frame(self, index: int) -> np.ndarray:
        return self._read_at(int(index))

    def read_frames(self, indices) -> np.ndarray:
        return np.stack([self._read_at(int(i)) for i in indices])

    def iter_frames(
        self, start: int = 0, stop: Optional[int] = None
    ) -> Iterator[np.ndarray]:
        stop = self.n_frames if stop is None else min(stop, self.n_frames)
        for i in range(start, stop):
            yield self._read_at(i)

    def close(self) -> None:
        self._cap.release()
