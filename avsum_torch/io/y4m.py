"""YUV4MPEG2 (.y4m) uncompressed video codec, pure NumPy.

The decode substrate for this framework's tests/benchmarks (no ffmpeg/cv2
exists in the image; real-world H.264 ingest plugs in behind the same
VideoReader interface). Y4M is a text header plus raw planar frames —
decode cost is essentially memcpy + chroma upsample, which is exactly the
shape of workload the native C++ fast path (native/avsumio) accelerates.

Supports C420 (with jpeg/mpeg2/paldv variants treated as centered), C422
and C444, 8-bit.
"""

from __future__ import annotations

import io as _io
import os
from typing import Iterator, Optional, Tuple

import numpy as np

# BT.601 full-range YCbCr <-> RGB (the convention cv2 uses for YUV2RGB)
_KR, _KG, _KB = 0.299, 0.587, 0.114


def rgb_to_yuv420(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[H, W, 3] uint8 RGB -> (Y [H,W], U [H/2,W/2], V [H/2,W/2]) uint8."""
    x = rgb.astype(np.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = _KR * r + _KG * g + _KB * b
    u = (b - y) / (2.0 * (1.0 - _KB)) + 128.0
    v = (r - y) / (2.0 * (1.0 - _KR)) + 128.0
    h2, w2 = (y.shape[0] // 2) * 2, (y.shape[1] // 2) * 2
    u_sub = u[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).mean(axis=(1, 3))
    v_sub = v[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).mean(axis=(1, 3))
    clip = lambda a: np.clip(np.round(a), 0, 255).astype(np.uint8)
    return clip(y), clip(u_sub), clip(v_sub)


def yuv_full_to_rgb(y: np.ndarray, u_full: np.ndarray, v_full: np.ndarray) -> np.ndarray:
    """Full-resolution planar YUV -> [H, W, 3] uint8 RGB."""
    yf = y.astype(np.float32)
    uf = u_full.astype(np.float32) - 128.0
    vf = v_full.astype(np.float32) - 128.0
    r = yf + 2.0 * (1.0 - _KR) * vf
    b = yf + 2.0 * (1.0 - _KB) * uf
    g = (yf - _KR * r - _KB * b) / _KG
    return np.clip(np.round(np.stack([r, g, b], -1)), 0, 255).astype(np.uint8)


def yuv420_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Planar 4:2:0 -> [H, W, 3] uint8 RGB (nearest chroma upsample)."""
    u_full = np.repeat(np.repeat(u, 2, 0), 2, 1)[: y.shape[0], : y.shape[1]]
    v_full = np.repeat(np.repeat(v, 2, 0), 2, 1)[: y.shape[0], : y.shape[1]]
    return yuv_full_to_rgb(y, u_full, v_full)


def write_y4m(
    path: str, frames: np.ndarray, fps: float = 30.0, fps_den: int = 1
) -> None:
    """[T, H, W, 3] uint8 RGB -> .y4m (C420)."""
    frames = np.asarray(frames)
    t, h, w, _ = frames.shape
    if isinstance(fps, float) and not fps.is_integer():
        # represent e.g. 29.97 as 30000/1001
        fps_num, fps_den = int(round(fps * 1001)), 1001
    else:
        fps_num, fps_den = int(fps), fps_den
    with open(path, "wb") as fh:
        fh.write(
            f"YUV4MPEG2 W{w} H{h} F{fps_num}:{fps_den} Ip A1:1 C420\n".encode()
        )
        for i in range(t):
            yp, up, vp = rgb_to_yuv420(frames[i])
            fh.write(b"FRAME\n")
            fh.write(yp.tobytes())
            fh.write(up.tobytes())
            fh.write(vp.tobytes())


class Y4MReader:
    """Random-access .y4m reader (frames are fixed-size -> O(1) seek)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        header = self._fh.readline().decode("ascii", "replace").strip()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError(f"{path}: not a Y4M file")
        self.width = self.height = 0
        self.fps = 30.0
        self.colorspace = "C420"
        for token in header.split()[1:]:
            if token[0] == "W":
                self.width = int(token[1:])
            elif token[0] == "H":
                self.height = int(token[1:])
            elif token[0] == "F":
                num, den = token[1:].split(":")
                self.fps = int(num) / int(den)
            elif token[0] == "C":
                self.colorspace = token
        if self.colorspace.startswith("C420"):
            self._chroma_div = (2, 2)
        elif self.colorspace.startswith("C422"):
            self._chroma_div = (1, 2)
        elif self.colorspace.startswith("C444"):
            self._chroma_div = (1, 1)
        else:
            raise ValueError(f"unsupported colorspace {self.colorspace}")
        ch, cw = self._chroma_div
        self._ysize = self.width * self.height
        self._csize = (self.height // ch) * (self.width // cw)
        self._data_start = self._fh.tell()
        # Y4M frame markers may carry parameters ("FRAME <params>\n"); the
        # fixed-stride seek below requires every frame header to have the
        # SAME length, so measure it from the first frame and validate on
        # each decode (mixed-length headers raise a clear error).
        first_marker = self._fh.readline()
        if not first_marker.startswith(b"FRAME"):
            raise ValueError(f"{path}: missing FRAME marker")
        self._marker_len = len(first_marker)
        self._frame_bytes = self._marker_len + self._ysize + 2 * self._csize
        self._fh.seek(0, os.SEEK_END)
        total_bytes = self._fh.tell() - self._data_start
        self.n_frames = total_bytes // self._frame_bytes

    def _decode_at(self, index: int) -> np.ndarray:
        self._fh.seek(self._data_start + index * self._frame_bytes)
        blob = self._fh.read(self._frame_bytes)
        if not blob.startswith(b"FRAME") or blob[self._marker_len - 1] != 0x0A:
            raise ValueError(
                f"{self.path}: frame {index} header mismatch — Y4M files "
                "with variable-length frame parameters are not supported"
            )
        raw = blob[self._marker_len :]
        y = np.frombuffer(raw[: self._ysize], np.uint8).reshape(
            self.height, self.width
        )
        ch, cw = self._chroma_div
        hh, ww = self.height // ch, self.width // cw
        u = np.frombuffer(
            raw[self._ysize : self._ysize + self._csize], np.uint8
        ).reshape(hh, ww)
        v = np.frombuffer(raw[self._ysize + self._csize :], np.uint8).reshape(hh, ww)
        if self._chroma_div == (2, 2):
            return yuv420_to_rgb(y, u, v)
        u_full = np.repeat(np.repeat(u, ch, 0), cw, 1)[: self.height, : self.width]
        v_full = np.repeat(np.repeat(v, ch, 0), cw, 1)[: self.height, : self.width]
        return yuv_full_to_rgb(y, u_full, v_full)

    def read_frame(self, index: int) -> np.ndarray:
        if not 0 <= index < self.n_frames:
            raise IndexError(index)
        return self._decode_at(index)

    def read_frames(self, indices) -> np.ndarray:
        return np.stack([self.read_frame(int(i)) for i in indices])

    def read_frames_scaled(self, indices, scale: int) -> np.ndarray:
        """Nearest-subsampled frames (PySceneDetect-style downscale)."""
        if scale == 1:
            return self.read_frames(indices)
        return np.stack(
            [self.read_frame(int(i))[::scale, ::scale] for i in indices]
        )

    def iter_frames(self, start: int = 0, stop: Optional[int] = None) -> Iterator[np.ndarray]:
        stop = self.n_frames if stop is None else min(stop, self.n_frames)
        for i in range(start, stop):
            yield self.read_frame(i)

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


