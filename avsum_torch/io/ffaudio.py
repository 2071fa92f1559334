"""In-container audio decode via the ffmpeg libraries bundled with OpenCV.

The reference extracted a video's soundtrack by shelling out to ffmpeg
through pydub (reference/features/extractors.py:364-386). This
image has no ffmpeg binary and no pydub, but the ``opencv-python`` wheel
ships the real ffmpeg 8.x shared libraries (libavformat/libavcodec/
libavutil under ``opencv_python.libs/``) for its VideoCapture backend.
This module binds them directly with ctypes, giving the pipeline
in-process decode of ANY audio codec ffmpeg knows (AAC/MP3/Opus/PCM/...)
from any container (mp4/mkv/avi/wav/...), without a subprocess.

ABI strategy — ctypes against a library we did not compile is only safe
where the layout is pinned:

- Functions: all calls go through the public, versioned C API
  (``avformat_open_input`` .. ``avcodec_receive_frame``) — no inlines.
- Structs: only ABI-stable *prefixes* are declared (``AVPacket`` through
  ``stream_index``, ``AVFrame`` through ``format``, ``AVFormatContext``
  through ``streams``, ``AVStream`` through ``codecpar``,
  ``AVCodecParameters``'s leading ``codec_type``/``codec_id``). These
  prefixes are unchanged across ffmpeg 5-8 (majors 59-62).
- Everything deeper (``AVCodecParameters.sample_rate`` /
  ``ch_layout.nb_channels``, which moved across majors) is located by an
  *empirical probe* at init: two synthetic WAV files with distinctive
  rates/channel counts are opened and the only int32 offset whose value
  tracks (rate, channels) across both is taken.
- A full round-trip self-test (decode a known stereo ramp WAV and
  compare bit-exactly) gates availability: if ANY assumption fails on a
  future library, :func:`ffmpeg_audio_available` turns False and callers
  fall back to the paired-``.wav`` convention — never garbage audio.
"""

from __future__ import annotations

import ctypes as C
import glob
import logging
import os
import struct
import tempfile
import threading
from typing import List, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

AVMEDIA_TYPE_AUDIO = 1

# AVSampleFormat (libavutil/samplefmt.h — stable enum since ffmpeg 1.x)
_FMT_U8, _FMT_S16, _FMT_S32, _FMT_FLT, _FMT_DBL = 0, 1, 2, 3, 4
_FMT_U8P, _FMT_S16P, _FMT_S32P, _FMT_FLTP, _FMT_DBLP = 5, 6, 7, 8, 9
_FMT_S64, _FMT_S64P = 10, 11
_PLANAR = {_FMT_U8P, _FMT_S16P, _FMT_S32P, _FMT_FLTP, _FMT_DBLP, _FMT_S64P}
_DTYPES = {
    _FMT_U8: np.uint8, _FMT_U8P: np.uint8,
    _FMT_S16: np.int16, _FMT_S16P: np.int16,
    _FMT_S32: np.int32, _FMT_S32P: np.int32,
    _FMT_FLT: np.float32, _FMT_FLTP: np.float32,
    _FMT_DBL: np.float64, _FMT_DBLP: np.float64,
    _FMT_S64: np.int64, _FMT_S64P: np.int64,
}

_AVERROR_EAGAIN = -11  # AVERROR(EAGAIN) on linux
_AVERROR_EOF = -0x20464F45  # FFERRTAG('E','O','F',' ') == AVERROR_EOF


class FFAudioError(RuntimeError):
    """Raised when the bundled ffmpeg path cannot decode a file."""


class FFNoAudioStream(FFAudioError):
    """The container genuinely carries no audio stream (as opposed to one
    we cannot decode) — callers may substitute silence, mirroring the
    native demuxer's ``Mp4NoAudioTrack``."""


# ---------------------------------------------------------------------------
# ABI-stable struct prefixes (see module docstring before editing)
# ---------------------------------------------------------------------------

class _AVPacketPrefix(C.Structure):
    _fields_ = [
        ("buf", C.c_void_p),
        ("pts", C.c_int64),
        ("dts", C.c_int64),
        ("data", C.c_void_p),
        ("size", C.c_int),
        ("stream_index", C.c_int),
    ]


class _AVFramePrefix(C.Structure):
    _fields_ = [
        ("data", C.c_void_p * 8),
        ("linesize", C.c_int * 8),
        ("extended_data", C.POINTER(C.c_void_p)),
        ("width", C.c_int),
        ("height", C.c_int),
        ("nb_samples", C.c_int),
        ("format", C.c_int),
    ]


class _AVFormatContextPrefix(C.Structure):
    _fields_ = [
        ("av_class", C.c_void_p),
        ("iformat", C.c_void_p),
        ("oformat", C.c_void_p),
        ("priv_data", C.c_void_p),
        ("pb", C.c_void_p),
        ("ctx_flags", C.c_int),
        ("nb_streams", C.c_uint),
        ("streams", C.POINTER(C.c_void_p)),
    ]


class _AVStreamPrefix(C.Structure):
    # ffmpeg >= 5.0 (lavf major >= 59): AVClass pointer leads
    _fields_ = [
        ("av_class", C.c_void_p),
        ("index", C.c_int),
        ("id", C.c_int),
        ("codecpar", C.c_void_p),
    ]


class _AVCodecParametersPrefix(C.Structure):
    _fields_ = [
        ("codec_type", C.c_int),
        ("codec_id", C.c_int),
        ("codec_tag", C.c_uint32),
    ]


def _find_libdir() -> Optional[str]:
    override = os.environ.get("AVSUM_FFMPEG_LIBS")
    if override:
        return override if os.path.isdir(override) else None
    try:
        import cv2
    except Exception:
        return None
    site = os.path.dirname(os.path.dirname(os.path.abspath(cv2.__file__)))
    for name in ("opencv_python.libs", "opencv_python_headless.libs"):
        cand = os.path.join(site, name)
        if glob.glob(os.path.join(cand, "libavformat*.so*")):
            return cand
    return None


class _FF:
    """Loaded libraries + resolved function prototypes + probed offsets."""

    def __init__(self, libdir: str):
        def _load(stem: str) -> C.CDLL:
            paths = sorted(glob.glob(os.path.join(libdir, f"lib{stem}*.so*")))
            if not paths:
                raise FFAudioError(f"lib{stem} not found in {libdir}")
            # mangled DT_NEEDED + $ORIGIN rpath resolve the dependencies
            return C.CDLL(paths[0], mode=C.RTLD_GLOBAL)

        self.avu = _load("avutil")
        self.avc = _load("avcodec")
        self.avf = _load("avformat")

        fmt_major = self.avf.avformat_version() >> 16
        if not (59 <= fmt_major <= 63):
            raise FFAudioError(
                f"libavformat major {fmt_major} outside the validated 59-63 "
                "range (struct prefixes unverified)"
            )

        a = self.avf
        a.avformat_open_input.restype = C.c_int
        a.avformat_open_input.argtypes = [
            C.POINTER(C.c_void_p), C.c_char_p, C.c_void_p, C.c_void_p]
        a.avformat_find_stream_info.restype = C.c_int
        a.avformat_find_stream_info.argtypes = [C.c_void_p, C.c_void_p]
        a.av_find_best_stream.restype = C.c_int
        a.av_find_best_stream.argtypes = [
            C.c_void_p, C.c_int, C.c_int, C.c_int,
            C.POINTER(C.c_void_p), C.c_int]
        a.av_read_frame.restype = C.c_int
        a.av_read_frame.argtypes = [C.c_void_p, C.c_void_p]
        a.avformat_close_input.argtypes = [C.POINTER(C.c_void_p)]

        c = self.avc
        c.avcodec_alloc_context3.restype = C.c_void_p
        c.avcodec_alloc_context3.argtypes = [C.c_void_p]
        c.avcodec_parameters_to_context.restype = C.c_int
        c.avcodec_parameters_to_context.argtypes = [C.c_void_p, C.c_void_p]
        c.avcodec_open2.restype = C.c_int
        c.avcodec_open2.argtypes = [C.c_void_p, C.c_void_p, C.c_void_p]
        c.avcodec_send_packet.restype = C.c_int
        c.avcodec_send_packet.argtypes = [C.c_void_p, C.c_void_p]
        c.avcodec_receive_frame.restype = C.c_int
        c.avcodec_receive_frame.argtypes = [C.c_void_p, C.c_void_p]
        c.avcodec_free_context.argtypes = [C.POINTER(C.c_void_p)]
        c.av_packet_alloc.restype = C.c_void_p
        c.av_packet_alloc.argtypes = []
        c.av_packet_unref.argtypes = [C.c_void_p]
        c.av_packet_free.argtypes = [C.POINTER(C.c_void_p)]

        c.avcodec_find_encoder_by_name.restype = C.c_void_p
        c.avcodec_find_encoder_by_name.argtypes = [C.c_char_p]
        c.avcodec_send_frame.restype = C.c_int
        c.avcodec_send_frame.argtypes = [C.c_void_p, C.c_void_p]
        c.avcodec_receive_packet.restype = C.c_int
        c.avcodec_receive_packet.argtypes = [C.c_void_p, C.c_void_p]

        u = self.avu
        u.av_frame_alloc.restype = C.c_void_p
        u.av_frame_alloc.argtypes = []
        u.av_frame_unref.argtypes = [C.c_void_p]
        u.av_frame_free.argtypes = [C.POINTER(C.c_void_p)]
        u.av_opt_set_int.restype = C.c_int
        u.av_opt_set_int.argtypes = [
            C.c_void_p, C.c_char_p, C.c_int64, C.c_int]
        u.av_opt_set.restype = C.c_int
        u.av_opt_set.argtypes = [C.c_void_p, C.c_char_p, C.c_char_p, C.c_int]

        # filled by the init-time probes
        self.off_sample_rate: int = -1          # in AVCodecParameters
        self.off_nb_channels: int = -1          # in AVCodecParameters
        self.ctx_off_sample_rate: int = -1      # in AVCodecContext
        self.ctx_off_sample_fmt: int = -1       # in AVCodecContext
        self.ctx_off_ch_layout: int = -1        # in AVCodecContext
        self.frame_off_sample_rate: int = -1    # in AVFrame
        self.frame_off_ch_layout: int = -1      # in AVFrame


_lock = threading.Lock()
_ff: Optional[_FF] = None
_ff_failed = False


def _codecpar_int(ff: _FF, codecpar: int, offset: int) -> int:
    return C.cast(codecpar + offset, C.POINTER(C.c_int)).contents.value


class _Demux:
    """One open container + (optionally) its best audio stream decoder."""

    def __init__(self, ff: _FF, path: str):
        self.ff = ff
        self.fmt = C.c_void_p(None)
        self.cctx = C.c_void_p(None)
        self.pkt = C.c_void_p(None)
        self.frm = C.c_void_p(None)
        ret = ff.avf.avformat_open_input(
            C.byref(self.fmt), path.encode(), None, None)
        if ret < 0:
            raise FFAudioError(f"avformat cannot open {path!r} ({ret})")
        ret = ff.avf.avformat_find_stream_info(self.fmt, None)
        if ret < 0:
            self.close()
            raise FFAudioError(f"no stream info in {path!r} ({ret})")

    def audio_codecpar(self) -> Tuple[int, int]:
        """-> (stream_index, codecpar address) of the best audio stream."""
        dec = C.c_void_p(None)
        idx = self.ff.avf.av_find_best_stream(
            self.fmt, AVMEDIA_TYPE_AUDIO, -1, -1, C.byref(dec), 0)
        if idx < 0:
            # distinguish "no audio track" from "no decoder for it" by
            # scanning the streams ourselves (avoids error-tag guessing)
            has_audio = False
            fctx = C.cast(
                self.fmt, C.POINTER(_AVFormatContextPrefix)).contents
            if 0 < fctx.nb_streams <= 4096:
                for i in range(fctx.nb_streams):
                    st = C.cast(
                        fctx.streams[i], C.POINTER(_AVStreamPrefix)).contents
                    par = C.cast(
                        st.codecpar, C.POINTER(_AVCodecParametersPrefix))
                    if par.contents.codec_type == AVMEDIA_TYPE_AUDIO:
                        has_audio = True
            self.close()
            if not has_audio:
                raise FFNoAudioStream("container has no audio stream")
            raise FFAudioError("no decoder for the container's audio stream")
        self._dec = dec
        fctx = C.cast(self.fmt, C.POINTER(_AVFormatContextPrefix)).contents
        if not (0 < fctx.nb_streams <= 4096) or idx >= fctx.nb_streams:
            self.close()
            raise FFAudioError("implausible AVFormatContext layout")
        st = C.cast(
            fctx.streams[idx], C.POINTER(_AVStreamPrefix)).contents
        par = C.cast(st.codecpar, C.POINTER(_AVCodecParametersPrefix))
        if st.index != idx or par.contents.codec_type != AVMEDIA_TYPE_AUDIO:
            self.close()
            raise FFAudioError("implausible AVStream layout")
        return idx, st.codecpar

    def open_decoder(self, codecpar: int) -> None:
        ff = self.ff
        self.cctx = C.c_void_p(ff.avc.avcodec_alloc_context3(self._dec))
        if not self.cctx:
            self.close()
            raise FFAudioError("avcodec_alloc_context3 failed")
        if ff.avc.avcodec_parameters_to_context(self.cctx, codecpar) < 0:
            self.close()
            raise FFAudioError("avcodec_parameters_to_context failed")
        if ff.avc.avcodec_open2(self.cctx, self._dec, None) < 0:
            self.close()
            raise FFAudioError("decoder open failed")
        self.pkt = C.c_void_p(ff.avc.av_packet_alloc())
        self.frm = C.c_void_p(ff.avu.av_frame_alloc())
        if not self.pkt or not self.frm:
            self.close()
            raise FFAudioError("packet/frame alloc failed")

    def close(self) -> None:
        ff = self.ff
        if getattr(self, "frm", None):
            ff.avu.av_frame_free(C.byref(self.frm))
        if getattr(self, "pkt", None):
            ff.avc.av_packet_free(C.byref(self.pkt))
        if getattr(self, "cctx", None):
            ff.avc.avcodec_free_context(C.byref(self.cctx))
        if getattr(self, "fmt", None):
            ff.avf.avformat_close_input(C.byref(self.fmt))
        self.frm = self.pkt = self.cctx = self.fmt = C.c_void_p(None)


def _frame_samples(frm_addr: int, channels: int) -> np.ndarray:
    """Decoded AVFrame -> float32 [nb_samples, channels] in [-1, 1]."""
    frm = C.cast(frm_addr, C.POINTER(_AVFramePrefix)).contents
    fmt, n = frm.format, frm.nb_samples
    if n <= 0:
        return np.zeros((0, channels), np.float32)
    dtype = _DTYPES.get(fmt)
    if dtype is None:
        raise FFAudioError(f"unsupported decoded sample format {fmt}")
    item = np.dtype(dtype).itemsize
    if fmt in _PLANAR:
        planes = []
        # >8 channels spill past AVFrame.data into extended_data; the
        # pipeline downmixes to mono anyway, 8 planes are plenty
        for ch in range(min(channels, 8)):
            buf = C.string_at(frm.data[ch], n * item)
            planes.append(np.frombuffer(buf, dtype))
        x = np.stack(planes, axis=1)
    else:
        buf = C.string_at(frm.data[0], n * channels * item)
        x = np.frombuffer(buf, dtype).reshape(n, channels)
    if dtype == np.uint8:
        return (x.astype(np.float32) - 128.0) / 128.0
    if dtype == np.int16:
        return x.astype(np.float32) / 32768.0
    if dtype == np.int32:
        return x.astype(np.float32) / 2147483648.0
    if dtype == np.int64:
        return (x.astype(np.float64) / 9223372036854775808.0).astype(np.float32)
    return x.astype(np.float32)


def _decode_with(ff: _FF, path: str) -> Tuple[np.ndarray, int]:
    dmx = _Demux(ff, path)
    try:
        idx, codecpar = dmx.audio_codecpar()
        rate = _codecpar_int(ff, codecpar, ff.off_sample_rate)
        channels = _codecpar_int(ff, codecpar, ff.off_nb_channels)
        if not (1 <= channels <= 64) or not (1000 <= rate <= 768000):
            raise FFAudioError(
                f"implausible stream params rate={rate} ch={channels}")
        dmx.open_decoder(codecpar)
        chunks: List[np.ndarray] = []

        def _drain() -> bool:
            while True:
                ret = ff.avc.avcodec_receive_frame(dmx.cctx, dmx.frm)
                if ret == _AVERROR_EAGAIN:
                    return True
                if ret == _AVERROR_EOF:
                    return False
                if ret < 0:
                    raise FFAudioError(f"receive_frame failed ({ret})")
                chunks.append(_frame_samples(dmx.frm.value, channels))
                ff.avu.av_frame_unref(dmx.frm)

        while ff.avf.av_read_frame(dmx.fmt, dmx.pkt) >= 0:
            pkt = C.cast(dmx.pkt, C.POINTER(_AVPacketPrefix)).contents
            if pkt.stream_index == idx:
                if ff.avc.avcodec_send_packet(dmx.cctx, dmx.pkt) < 0:
                    raise FFAudioError("send_packet failed")
                _drain()
            ff.avc.av_packet_unref(dmx.pkt)
        ff.avc.avcodec_send_packet(dmx.cctx, None)  # flush
        _drain()
    finally:
        dmx.close()
    if not chunks:
        raise FFAudioError(f"no audio frames decoded from {path!r}")
    return np.concatenate(chunks, axis=0), rate


# ---------------------------------------------------------------------------
# init-time offset probe + self-test
# ---------------------------------------------------------------------------

def _write_probe_wav(path: str, rate: int, channels: int,
                     samples: np.ndarray, float32: bool = False) -> None:
    if float32:
        data = np.asarray(samples, "<f4").tobytes()
        fmt_code, bits = 3, 32
    else:
        data = np.clip(
            np.round(samples * 32767.0), -32768, 32767).astype("<i2").tobytes()
        fmt_code, bits = 1, 16
    bytes_per = bits // 8
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt ")
        fh.write(struct.pack(
            "<IHHIIHH", 16, fmt_code, channels, rate,
            rate * channels * bytes_per, channels * bytes_per, bits))
        fh.write(b"data" + struct.pack("<I", len(data)) + data)


def _usable_size(addr: int, cap: int) -> int:
    """glibc malloc_usable_size bounds struct-memory scans so they can
    never cross the end of the allocation."""
    try:
        libc = C.CDLL(None)
        libc.malloc_usable_size.restype = C.c_size_t
        libc.malloc_usable_size.argtypes = [C.c_void_p]
        usable = int(libc.malloc_usable_size(addr))
        if usable > 0:
            return min(usable, cap)
    except Exception:
        pass
    return min(240, cap)  # conservative: inside every ffmpeg 5-8 layout


def _scan_int(addr: int, value: int, cap: int = 1024) -> set:
    """4-aligned byte offsets within the allocation holding int32 value."""
    n = _usable_size(addr, cap) // 4
    arr = np.ctypeslib.as_array(
        C.cast(addr, C.POINTER(C.c_int32)), shape=(n,))
    return {int(i) * 4 for i in np.nonzero(arr == value)[0]}


def _scan_chlayout(addr: int, nb: int, mask: int, cap: int = 1024) -> set:
    """4-aligned offsets matching AVChannelLayout for ``nb`` channels:
    either NATIVE order with the expected mask, or UNSPEC order with a
    zero mask (what plain WAV demux produces — no channel mask info)."""
    nbytes = _usable_size(addr, cap)
    raw = C.string_at(addr, nbytes)
    out = set()
    for off in range(0, nbytes - 16, 4):
        order, got_nb = struct.unpack_from("<ii", raw, off)
        (got_mask,) = struct.unpack_from("<Q", raw, off + 8)
        if got_nb != nb:
            continue
        if (order, got_mask) in ((1, mask), (0, 0)):
            out.add(off)
    return out


def _probe_one(ff: _FF, path: str, rate: int, ch: int, mask: int,
               sample_fmt: int) -> dict:
    """Open+decode one probe WAV, returning candidate offset sets for
    every deep field (codecpar, codec context, decoded frame)."""
    got: dict = {}
    dmx = _Demux(ff, path)
    try:
        idx, codecpar = dmx.audio_codecpar()
        got["par_rate"] = _scan_int(codecpar, rate)
        got["par_ch"] = _scan_int(codecpar, ch)
        dmx.open_decoder(codecpar)
        cctx = dmx.cctx.value
        got["ctx_rate"] = _scan_int(cctx, rate, cap=2048)
        got["ctx_fmt"] = _scan_int(cctx, sample_fmt, cap=2048)
        got["ctx_layout"] = _scan_chlayout(cctx, ch, mask, cap=2048)
        got["frame_rate"] = got["frame_layout"] = None
        while ff.avf.av_read_frame(dmx.fmt, dmx.pkt) >= 0:
            pkt = C.cast(dmx.pkt, C.POINTER(_AVPacketPrefix)).contents
            take = pkt.stream_index == idx
            if take and ff.avc.avcodec_send_packet(dmx.cctx, dmx.pkt) < 0:
                raise FFAudioError("probe send_packet failed")
            ff.avc.av_packet_unref(dmx.pkt)
            if take and ff.avc.avcodec_receive_frame(dmx.cctx, dmx.frm) == 0:
                frm = dmx.frm.value
                got["frame_rate"] = _scan_int(frm, rate)
                got["frame_layout"] = _scan_chlayout(frm, ch, mask)
                break
        if got["frame_rate"] is None:
            raise FFAudioError("probe decoded no frame")
    finally:
        dmx.close()
    return got


def _unique(inter: set, what: str) -> int:
    if len(inter) != 1:
        raise FFAudioError(f"{what} offset ambiguous: {sorted(inter)}")
    return inter.pop()


def _probe_and_selftest(ff: _FF) -> None:
    """Locate every version-dependent field offset empirically, then
    round-trip a WAV bit-exactly. Probe files use distinctive prime-ish
    rates so collisions with unrelated fields are implausible; every
    field must resolve to exactly ONE offset across both probes or the
    backend is disabled."""
    rng = np.random.RandomState(12345)
    with tempfile.TemporaryDirectory(prefix="ffaudio_probe_") as tmp:
        # (rate, channels, native layout mask, decoded sample_fmt)
        specs = [(22567, 1, 0x4, _FMT_S16, False),
                 (44101, 2, 0x3, _FMT_FLT, True)]
        probes = []
        for i, (rate, ch, mask, fmt, f32) in enumerate(specs):
            p = os.path.join(tmp, f"probe{i}.wav")
            _write_probe_wav(
                p, rate, ch, rng.uniform(-0.5, 0.5, (256, ch)), float32=f32)
            probes.append(_probe_one(ff, p, rate, ch, mask, fmt))
        a, b = probes

        ff.off_sample_rate = _unique(
            a["par_rate"] & b["par_rate"], "codecpar sample_rate")
        # channels: 1/2 also matches enum fields; anchor to the
        # AVChannelLayout that sits within 32 bytes before sample_rate in
        # every ffmpeg 5-8 layout
        par_ch = {
            o for o in (a["par_ch"] & b["par_ch"])
            if ff.off_sample_rate - 32 <= o < ff.off_sample_rate}
        ff.off_nb_channels = _unique(par_ch, "codecpar nb_channels")

        # frame/codec-context offsets only gate the ENCODE path: resolve
        # best-effort and leave -1 (encode unavailable) when ambiguous
        try:
            ff.frame_off_sample_rate = _unique(
                a["frame_rate"] & b["frame_rate"], "frame sample_rate")
            ff.frame_off_ch_layout = _unique(
                a["frame_layout"] & b["frame_layout"], "frame ch_layout")
            ff.ctx_off_ch_layout = _unique(
                a["ctx_layout"] & b["ctx_layout"], "ctx ch_layout")
            # sample_rate may also appear in unrelated ctx fields (e.g.
            # framerate paths); anchor to the int adjacent to ch_layout —
            # sample_rate immediately precedes it in every ffmpeg 5-8
            ctx_rate = {
                o for o in (a["ctx_rate"] & b["ctx_rate"])
                if ff.ctx_off_ch_layout - 16 <= o < ff.ctx_off_ch_layout}
            ff.ctx_off_sample_rate = _unique(ctx_rate, "ctx sample_rate")
            # sample_fmt likewise sits between sample_rate and ch_layout
            ctx_fmt = {
                o for o in (a["ctx_fmt"] & b["ctx_fmt"])
                if ff.ctx_off_sample_rate < o < ff.ctx_off_ch_layout}
            ff.ctx_off_sample_fmt = _unique(ctx_fmt, "ctx sample_fmt")
        except FFAudioError as e:
            ff.ctx_off_sample_fmt = -1  # encode gate
            log.info("ffaudio encode path disabled: %s", e)

        # full-path self-test: stereo ramp at an uncommon rate, bit-exact
        rate, t = 22050, 512
        ramp = np.stack([
            np.linspace(-0.9, 0.9, t, dtype=np.float32),
            np.linspace(0.9, -0.9, t, dtype=np.float32)], axis=1)
        p = os.path.join(tmp, "selftest.wav")
        _write_probe_wav(p, rate, 2, ramp)
        got, got_rate = _decode_with(ff, p)
        want = np.clip(np.round(ramp * 32767.0), -32768, 32767) / 32768.0
        if got_rate != rate or got.shape != (t, 2):
            raise FFAudioError(
                f"self-test shape/rate mismatch: {got.shape}@{got_rate}")
        if not np.allclose(got, want.astype(np.float32), atol=1e-6):
            raise FFAudioError("self-test sample mismatch")


def _get_ff() -> Optional[_FF]:
    global _ff, _ff_failed
    with _lock:
        if _ff is not None or _ff_failed:
            return _ff
        libdir = _find_libdir()
        if libdir is None:
            _ff_failed = True
            return None
        try:
            ff = _FF(libdir)
            _probe_and_selftest(ff)
        except Exception as e:  # any layout surprise -> unavailable
            log.warning("bundled-ffmpeg audio backend disabled: %s", e)
            _ff_failed = True
            return None
        log.info(
            "bundled-ffmpeg audio backend ready (%s; codecpar offsets "
            "rate=%d ch=%d)", libdir, ff.off_sample_rate, ff.off_nb_channels)
        _ff = ff
        return _ff


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def ffmpeg_audio_available() -> bool:
    """True when the bundled-ffmpeg decoder loaded AND passed its
    round-trip self-test in this process."""
    return _get_ff() is not None


def decode_audio(path: str) -> Tuple[np.ndarray, int]:
    """Decode ``path``'s best audio stream -> (float32 [T, C] in [-1, 1],
    sample_rate). Raises :class:`FFAudioError` when the backend is
    unavailable or the file carries no decodable audio."""
    ff = _get_ff()
    if ff is None:
        raise FFAudioError("bundled-ffmpeg audio backend unavailable")
    return _decode_with(ff, path)


def load_audio_mono_16k_ff(path: str) -> np.ndarray:
    """Container-audio equivalent of ``wav.load_audio_mono_16k``:
    decode -> channel-mean mono -> polyphase resample to 16 kHz."""
    from avsum_torch.io.wav import resample, to_mono

    samples, rate = decode_audio(path)
    return resample(to_mono(samples), rate, 16000)


# ---------------------------------------------------------------------------
# AAC encode (for generating real-dataset-shaped containers in-image)
# ---------------------------------------------------------------------------

# ISO/IEC 14496-3 sampling_frequency_index
_ASC_RATES = (96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
              16000, 12000, 11025, 8000, 7350)
AAC_SAMPLES_PER_FRAME = 1024


def aac_encode_available() -> bool:
    """True when the bundled libavcodec has the native AAC encoder AND
    the init probe resolved the codec-context offsets encoding needs."""
    ff = _get_ff()
    if ff is None or ff.ctx_off_sample_fmt < 0:
        return False
    return bool(ff.avc.avcodec_find_encoder_by_name(b"aac"))


def audio_specific_config(rate: int, channels: int = 1) -> bytes:
    """2-byte AAC-LC AudioSpecificConfig (14496-3 §1.6.2.1) — the
    DecoderSpecificInfo an 'mp4a' esds carries."""
    idx = _ASC_RATES.index(rate)
    return bytes([(2 << 3) | (idx >> 1), ((idx & 1) << 7) | (channels << 3)])


def encode_aac(samples: np.ndarray, rate: int,
               bit_rate: int = 96000) -> Tuple[List[bytes], bytes]:
    """Encode mono float32 [-1, 1] ``samples`` to AAC-LC.

    Returns (raw AAC access units — one per 1024-sample frame, no ADTS
    headers — and the matching 2-byte AudioSpecificConfig). Mux with
    ``mp4_mux.write_aac_mp4`` or wrap in ADTS for a bare .aac stream.
    """
    ff = _get_ff()
    if ff is None or ff.ctx_off_sample_fmt < 0:
        raise FFAudioError("AAC encode unavailable (backend or probe)")
    if rate not in _ASC_RATES:
        raise FFAudioError(f"AAC does not support sample rate {rate}")
    x = np.ascontiguousarray(np.asarray(samples, np.float32).reshape(-1))

    enc = C.c_void_p(ff.avc.avcodec_find_encoder_by_name(b"aac"))
    if not enc:
        raise FFAudioError("bundled libavcodec lacks the aac encoder")
    cctx = C.c_void_p(ff.avc.avcodec_alloc_context3(enc))
    if not cctx:
        raise FFAudioError("avcodec_alloc_context3 failed")
    frm = C.c_void_p(None)
    pkt = C.c_void_p(None)
    try:
        # configure through AVOptions (public, layout-independent) ...
        if ff.avu.av_opt_set_int(cctx, b"ar", rate, 0) < 0:
            raise FFAudioError("av_opt_set ar failed")
        if ff.avu.av_opt_set(cctx, b"ch_layout", b"mono", 0) < 0:
            raise FFAudioError("av_opt_set ch_layout failed")
        ff.avu.av_opt_set_int(cctx, b"b", bit_rate, 0)
        # ... except sample_fmt, which has no AVOption: probed offset
        C.cast(cctx.value + ff.ctx_off_sample_fmt,
               C.POINTER(C.c_int)).contents.value = _FMT_FLTP
        # cross-check the option writes landed where the probe says
        got_rate = C.cast(cctx.value + ff.ctx_off_sample_rate,
                          C.POINTER(C.c_int)).contents.value
        if got_rate != rate:
            raise FFAudioError("ctx sample_rate offset check failed")
        if ff.avc.avcodec_open2(cctx, enc, None) < 0:
            raise FFAudioError("aac encoder open failed")

        frm = C.c_void_p(ff.avu.av_frame_alloc())
        pkt = C.c_void_p(ff.avc.av_packet_alloc())
        if not frm or not pkt:
            raise FFAudioError("frame/packet alloc failed")
        packets: List[bytes] = []

        def _drain(final: bool) -> None:
            while True:
                ret = ff.avc.avcodec_receive_packet(cctx, pkt)
                if ret == _AVERROR_EAGAIN or ret == _AVERROR_EOF:
                    return
                if ret < 0:
                    raise FFAudioError(f"receive_packet failed ({ret})")
                p = C.cast(pkt, C.POINTER(_AVPacketPrefix)).contents
                packets.append(C.string_at(p.data, p.size))
                ff.avc.av_packet_unref(pkt)

        step = AAC_SAMPLES_PER_FRAME
        for start in range(0, max(len(x), 1), step):
            chunk = x[start:start + step]
            if len(chunk) == 0:
                break
            ff.avu.av_frame_unref(frm)
            pre = C.cast(frm, C.POINTER(_AVFramePrefix)).contents
            pre.nb_samples = len(chunk)
            pre.format = _FMT_FLTP
            pre.data[0] = chunk.ctypes.data
            pre.linesize[0] = len(chunk) * 4
            # extended_data must point at the data[] array (== frame base)
            pre.extended_data = C.cast(frm.value, C.POINTER(C.c_void_p))
            C.cast(frm.value + ff.frame_off_sample_rate,
                   C.POINTER(C.c_int)).contents.value = rate
            C.memmove(frm.value + ff.frame_off_ch_layout,
                      struct.pack("<iiQ", 1, 1, 0x4), 16)
            if ff.avc.avcodec_send_frame(cctx, frm) < 0:
                raise FFAudioError("send_frame failed")
            _drain(final=False)
            del chunk  # keep explicit: buffer was consumed synchronously
        if ff.avc.avcodec_send_frame(cctx, None) < 0:  # flush
            raise FFAudioError("encoder flush failed")
        _drain(final=True)
    finally:
        if frm:
            ff.avu.av_frame_free(C.byref(frm))
        if pkt:
            ff.avc.av_packet_free(C.byref(pkt))
        ff.avc.avcodec_free_context(C.byref(cctx))
    if not packets:
        raise FFAudioError("aac encoder produced no packets")
    return packets, audio_specific_config(rate, 1)
