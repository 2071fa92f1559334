"""ctypes bindings to the native C++ media runtime (native/avsumio).

The C++ library supplies the host-side hot path the single Python thread
can't: zero-copy Y4M demux + SIMD-friendly YUV->RGB + a background
prefetch thread that double-buffers decoded frame blocks while the TPU
computes (the reference's equivalent layer was cv2/ffmpeg subprocesses,
SURVEY.md §1 L1). Falls back cleanly when the library isn't built —
``native_available()`` gates every use.

Build: ``cmake -S native -B native/build && cmake --build native/build``
(or ``make -C native``); produces ``libavsumio.so`` next to this package.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, Optional

import numpy as np

_LIB = None
_SEARCHED = False


def _lib_paths():
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(os.path.dirname(here))
    return [
        os.path.join(root, "native", "build", "libavsumio.so"),
        os.path.join(root, "native", "libavsumio.so"),
        os.path.join(here, "libavsumio.so"),
    ]


def _load():
    global _LIB, _SEARCHED
    if _SEARCHED:
        return _LIB
    _SEARCHED = True
    for path in _lib_paths():
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                continue
            lib.avsumio_y4m_open.restype = ctypes.c_void_p
            lib.avsumio_y4m_open.argtypes = [ctypes.c_char_p]
            lib.avsumio_y4m_close.argtypes = [ctypes.c_void_p]
            lib.avsumio_y4m_info.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int),  # width
                ctypes.POINTER(ctypes.c_int),  # height
                ctypes.POINTER(ctypes.c_long),  # n_frames
                ctypes.POINTER(ctypes.c_double),  # fps
            ]
            lib.avsumio_y4m_read_rgb.restype = ctypes.c_int
            lib.avsumio_y4m_read_rgb.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_long),  # frame indices
                ctypes.c_long,  # count
                ctypes.c_void_p,  # out uint8 buffer [count, H, W, 3]
            ]
            lib.avsumio_y4m_read_rgb_scaled.restype = ctypes.c_int
            lib.avsumio_y4m_read_rgb_scaled.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_long),
                ctypes.c_long,
                ctypes.c_int,  # scale
                ctypes.c_void_p,
            ]
            lib.avsumio_y4m_read_yuv.restype = ctypes.c_int
            lib.avsumio_y4m_read_yuv.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_long),
                ctypes.c_long,
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            lib.avsumio_y4m_read_yuv_resized.restype = ctypes.c_int
            lib.avsumio_y4m_read_yuv_resized.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_long),
                ctypes.c_long,
                ctypes.c_int,  # out_w
                ctypes.c_int,  # out_h
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            lib.avsumio_content_scores.restype = ctypes.c_int
            lib.avsumio_content_scores.argtypes = [
                ctypes.c_void_p,
                ctypes.c_long,  # start
                ctypes.c_long,  # stop
                ctypes.c_int,  # scale
                ctypes.POINTER(ctypes.c_float),
            ]
            lib.avsumio_prefetch_start.restype = ctypes.c_int
            lib.avsumio_prefetch_start.argtypes = [
                ctypes.c_void_p,
                ctypes.c_long,  # block size (frames)
                ctypes.c_long,  # start frame
                ctypes.c_long,  # stop frame
                ctypes.c_long,  # stride
            ]
            lib.avsumio_prefetch_next.restype = ctypes.c_long
            lib.avsumio_prefetch_next.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p,  # out buffer
                ctypes.POINTER(ctypes.c_long),  # out first frame index
            ]
            lib.avsumio_prefetch_stop.argtypes = [ctypes.c_void_p]
            _LIB = lib
            break
    return _LIB


def native_available() -> bool:
    return _load() is not None


class NativeY4MReader:
    """Drop-in VideoReader backed by the C++ demuxer + prefetch thread."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("libavsumio.so not built")
        self._lib = lib
        self._handle = lib.avsumio_y4m_open(path.encode())
        if not self._handle:
            raise IOError(f"avsumio: cannot open {path}")
        w = ctypes.c_int()
        h = ctypes.c_int()
        n = ctypes.c_long()
        fps = ctypes.c_double()
        lib.avsumio_y4m_info(self._handle, w, h, n, fps)
        self.width, self.height = w.value, h.value
        self.n_frames, self.fps = n.value, fps.value
        self.path = path

    def read_frames(self, indices) -> np.ndarray:
        idx = np.ascontiguousarray(np.asarray(indices, np.int64))
        out = np.empty((len(idx), self.height, self.width, 3), np.uint8)
        rc = self._lib.avsumio_y4m_read_rgb(
            self._handle,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            len(idx),
            out.ctypes.data_as(ctypes.c_void_p),
        )
        if rc != 0:
            raise IOError(f"avsumio read failed rc={rc}")
        return out

    def read_frame(self, index: int) -> np.ndarray:
        return self.read_frames([index])[0]

    def read_yuv420(self, indices):
        """Raw YUV420 planes (Y [N,H,W], U/V [N,H/2,W/2]) — half the bytes
        of RGB for the host->device link; convert on device
        (:func:`avsum_torch.ops.color.yuv420_to_rgb`)."""
        idx = np.ascontiguousarray(np.asarray(indices, np.int64))
        n = len(idx)
        y = np.empty((n, self.height, self.width), np.uint8)
        u = np.empty((n, self.height // 2, self.width // 2), np.uint8)
        v = np.empty((n, self.height // 2, self.width // 2), np.uint8)
        rc = self._lib.avsumio_y4m_read_yuv(
            self._handle,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            n,
            y.ctypes.data_as(ctypes.c_void_p),
            u.ctypes.data_as(ctypes.c_void_p),
            v.ctypes.data_as(ctypes.c_void_p),
        )
        if rc != 0:
            raise IOError(f"avsumio yuv read failed rc={rc}")
        return y, u, v

    def read_yuv420_resized(self, indices, out_w: int, out_h: int):
        """YUV420 planes bilinearly resized ON HOST to (out_h, out_w) before
        the slow host->device link. The backbones resize to 224/299 anyway,
        so shipping ~304x304 instead of full frames cuts transferred bytes
        by the area ratio at equal model input quality. out dims even."""
        idx = np.ascontiguousarray(np.asarray(indices, np.int64))
        n = len(idx)
        y = np.empty((n, out_h, out_w), np.uint8)
        u = np.empty((n, out_h // 2, out_w // 2), np.uint8)
        v = np.empty((n, out_h // 2, out_w // 2), np.uint8)
        rc = self._lib.avsumio_y4m_read_yuv_resized(
            self._handle,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            n,
            out_w,
            out_h,
            y.ctypes.data_as(ctypes.c_void_p),
            u.ctypes.data_as(ctypes.c_void_p),
            v.ctypes.data_as(ctypes.c_void_p),
        )
        if rc != 0:
            raise IOError(f"avsumio yuv resized read failed rc={rc}")
        return y, u, v

    def read_yuv420_packed(
        self, indices, out_w: int, out_h: int, batch_cap: int
    ) -> np.ndarray:
        """Resized planes written straight into ONE contiguous uint8 buffer
        ``[cap*oy | cap*oc | cap*oc]`` (ys, then us, then vs; tail frames
        zeroed) — the single-transfer layout the visual frontend's
        ``_embed_packed`` consumes. Saves the host-side repack memcpy that
        a (y, u, v) triple would need before shipping."""
        idx = np.ascontiguousarray(np.asarray(indices, np.int64))
        n = len(idx)
        if n > batch_cap:
            raise ValueError(f"{n} frames > batch_cap {batch_cap}")
        oy = out_w * out_h
        oc = (out_w // 2) * (out_h // 2)
        buf = np.empty(batch_cap * (oy + 2 * oc), np.uint8)
        u0 = batch_cap * oy
        v0 = u0 + batch_cap * oc
        rc = self._lib.avsumio_y4m_read_yuv_resized(
            self._handle,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            n,
            out_w,
            out_h,
            ctypes.c_void_p(buf.ctypes.data),
            ctypes.c_void_p(buf.ctypes.data + u0),
            ctypes.c_void_p(buf.ctypes.data + v0),
        )
        if rc != 0:
            raise IOError(f"avsumio yuv packed read failed rc={rc}")
        if n < batch_cap:  # zero the pad tail of each plane section
            buf[n * oy : u0] = 0
            buf[u0 + n * oc : v0] = 0
            buf[v0 + n * oc :] = 0
        return buf

    def content_scores(
        self, start: int = 0, stop: Optional[int] = None, scale: int = 1
    ) -> np.ndarray:
        """Host-side ContentDetector scores [stop-start] — decode + HSV diff
        entirely in C++, zero bytes shipped to the device."""
        stop = self.n_frames if stop is None else min(stop, self.n_frames)
        out = np.empty(max(stop - start, 0), np.float32)
        if out.size == 0:
            return out
        rc = self._lib.avsumio_content_scores(
            self._handle,
            start,
            stop,
            scale,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc != 0:
            raise IOError(f"avsumio content_scores failed rc={rc}")
        return out

    def read_frames_scaled(self, indices, scale: int) -> np.ndarray:
        """Nearest-subsampled frames [N, H//scale, W//scale, 3] (for shot
        detection, which downscales like PySceneDetect)."""
        idx = np.ascontiguousarray(np.asarray(indices, np.int64))
        out = np.empty(
            (len(idx), self.height // scale, self.width // scale, 3), np.uint8
        )
        rc = self._lib.avsumio_y4m_read_rgb_scaled(
            self._handle,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            len(idx),
            scale,
            out.ctypes.data_as(ctypes.c_void_p),
        )
        if rc != 0:
            raise IOError(f"avsumio scaled read failed rc={rc}")
        return out

    def iter_frames(self, start: int = 0, stop: Optional[int] = None) -> Iterator[np.ndarray]:
        stop = self.n_frames if stop is None else min(stop, self.n_frames)
        block = 64
        for i in range(start, stop, block):
            for frame in self.read_frames(range(i, min(i + block, stop))):
                yield frame

    def iter_blocks(
        self,
        block_frames: int = 64,
        start: int = 0,
        stop: Optional[int] = None,
        stride: int = 1,
    ) -> Iterator[tuple]:
        """Prefetched (first_index, frames[block, H, W, 3]) blocks; the C++
        worker decodes block k+1 while Python/TPU consume block k."""
        stop = self.n_frames if stop is None else min(stop, self.n_frames)
        rc = self._lib.avsumio_prefetch_start(
            self._handle, block_frames, start, stop, stride
        )
        if rc != 0:
            raise IOError("avsumio prefetch start failed")
        try:
            while True:
                out = np.empty(
                    (block_frames, self.height, self.width, 3), np.uint8
                )
                first = ctypes.c_long()
                got = self._lib.avsumio_prefetch_next(
                    self._handle, out.ctypes.data_as(ctypes.c_void_p), first
                )
                if got <= 0:
                    return
                yield first.value, out[:got]
        finally:
            self._lib.avsumio_prefetch_stop(self._handle)

    def close(self):
        if self._handle:
            self._lib.avsumio_y4m_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
