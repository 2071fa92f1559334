"""ISO-BMFF (MP4/MOV) audio-track demuxer — in-container audio extraction.

The reference pulls the soundtrack out of the .mp4 itself via pydub/ffmpeg
(reference/features/extractors.py:364-386). This environment has no
codec libraries, so the rebuild demuxes the container directly: PCM audio
tracks (``sowt``/``twos``/``in16``/``fl32``/``ipcm``) decode with numpy
alone; compressed tracks (``mp4a``/AAC, ``ac-3``, ...) raise a clear error
pointing at the ``<stem>.wav`` sidecar convention rather than silently
substituting silence.

Box-tree walking is pure offset arithmetic over an mmap — no third-party
deps, O(header) memory until the sample bytes are gathered.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = [
    "Mp4Error",
    "Mp4NoAudioTrack",
    "Mp4NoVideoTrack",
    "Mp4UnsupportedCodec",
    "Mp4VideoReader",
    "extract_audio",
    "load_mp4_audio_mono_16k",
]


class Mp4Error(RuntimeError):
    pass


class Mp4NoAudioTrack(Mp4Error):
    """The container has no audio track at all."""


class Mp4NoVideoTrack(Mp4Error):
    """The container has no video track at all."""


class Mp4UnsupportedCodec(Mp4Error):
    """The audio track is compressed (e.g. AAC) — undecodable here."""


# fourcc -> (numpy dtype, is_float). All interleaved PCM frame formats.
_PCM_CODECS: Dict[bytes, Tuple[str, bool]] = {
    b"sowt": ("<i2", False),  # little-endian int16 (QuickTime)
    b"twos": (">i2", False),  # big-endian int16
    b"in16": (">i2", False),
    b"fl32": (">f4", True),
    b"fl64": (">f8", True),
}

_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"dinf", b"edts"}


def _iter_boxes(buf, start: int, end: int) -> Iterator[Tuple[bytes, int, int]]:
    """Yield (type, payload_start, payload_end) for boxes in [start, end)."""
    pos = start
    while pos + 8 <= end:
        size = struct.unpack_from(">I", buf, pos)[0]
        btype = bytes(buf[pos + 4 : pos + 8])
        header = 8
        if size == 1:  # 64-bit largesize
            if pos + 16 > end:
                return
            size = struct.unpack_from(">Q", buf, pos + 8)[0]
            header = 16
        elif size == 0:  # box extends to end of enclosing scope
            size = end - pos
        if size < header:
            return
        yield btype, pos + header, min(pos + size, end)
        pos += size


def _find(buf, start: int, end: int, btype: bytes) -> Optional[Tuple[int, int]]:
    for t, s, e in _iter_boxes(buf, start, end):
        if t == btype:
            return s, e
    return None


def _find_path(buf, start: int, end: int, path: List[bytes]):
    span = (start, end)
    for btype in path:
        span = _find(buf, span[0], span[1], btype)
        if span is None:
            return None
    return span


def _full_box(buf, start: int) -> Tuple[int, int, int]:
    """(version, flags, payload_start_after_verflags)."""
    ver_flags = struct.unpack_from(">I", buf, start)[0]
    return ver_flags >> 24, ver_flags & 0xFFFFFF, start + 4


def _read_u32s(buf, pos: int, n: int) -> np.ndarray:
    return np.frombuffer(buf, dtype=">u4", count=n, offset=pos).astype(np.int64)


def _read_u64s(buf, pos: int, n: int) -> np.ndarray:
    return np.frombuffer(buf, dtype=">u8", count=n, offset=pos).astype(np.int64)


class _AudioTrack:
    fourcc: bytes
    channels: int
    sample_rate: float
    sample_sizes: np.ndarray  # [n_samples] bytes
    chunk_offsets: np.ndarray  # [n_chunks] absolute file offsets
    samples_per_chunk: np.ndarray  # [n_chunks]
    pcm_frame_bytes: int  # bytes per PCM frame (all channels)


def _parse_stsd(buf, s: int, e: int, track: _AudioTrack) -> None:
    _, _, pos = _full_box(buf, s)
    pos += 4  # entry_count
    # first sample entry: size(4) fourcc(4) reserved(6) data_ref_index(2)
    track.fourcc = bytes(buf[pos + 4 : pos + 8])
    entry = pos + 8 + 8  # past reserved+dref index
    version = struct.unpack_from(">H", buf, entry)[0]
    # v0/v1 AudioSampleEntry: version(2) revision(2) vendor(4)
    # channelcount(2) samplesize(2) predefined(2) reserved(2) rate(4, 16.16)
    track.channels = struct.unpack_from(">H", buf, entry + 8)[0]
    bits = struct.unpack_from(">H", buf, entry + 10)[0]
    rate_fixed = struct.unpack_from(">I", buf, entry + 16)[0]
    track.sample_rate = rate_fixed / 65536.0
    if version == 1:
        # QT v1 adds 16 bytes (samples/packet etc.) — frame size still
        # derivable from codec dtype below
        pass
    if track.fourcc == b"ipcm":
        # ISO/IEC 23003-5 ipcm: endianness lives in the pcmC child box.
        # pcmC is a FullBox — 4 bytes version+flags (both zero), then the
        # payload: format_flags(1) with bit 0 = little-endian, PCM_bit_depth(1).
        entry_size = struct.unpack_from(">I", buf, pos)[0]
        little = False
        # scan past the AudioSampleEntry fields (v1 QT entries carry 16
        # extra bytes of samples/packet fields before child boxes)
        p = entry + 20 + (16 if version == 1 else 0)
        end = pos + entry_size
        while p + 8 <= end:
            bsize = struct.unpack_from(">I", buf, p)[0]
            if bsize < 8:
                break
            if bytes(buf[p + 4 : p + 8]) == b"pcmC" and p + 13 <= end:
                format_flags = buf[p + 12]  # first payload byte after verflags
                little = bool(format_flags & 1)
                break
            p += bsize
        track.fourcc = (
            (b"sowt" if little else b"twos") if bits == 16 else b"raw8"
        )
    elif track.fourcc in (b"raw ", b"lpcm"):
        # map raw/lpcm to an int16/int8 guess from the declared bits
        track.fourcc = b"sowt" if bits == 16 else b"raw8"
    dtype = _PCM_CODECS.get(track.fourcc)
    itemsize = np.dtype(dtype[0]).itemsize if dtype else max(bits // 8, 1)
    track.pcm_frame_bytes = itemsize * max(track.channels, 1)


def _parse_track(buf, trak_s: int, trak_e: int) -> Optional[_AudioTrack]:
    mdia = _find(buf, trak_s, trak_e, b"mdia")
    if mdia is None:
        return None
    hdlr = _find(buf, mdia[0], mdia[1], b"hdlr")
    if hdlr is None:
        return None
    _, _, hpos = _full_box(buf, hdlr[0])
    handler = bytes(buf[hpos + 4 : hpos + 8])
    if handler != b"soun":
        return None

    stbl = _find_path(buf, mdia[0], mdia[1], [b"minf", b"stbl"])
    if stbl is None:
        return None
    track = _AudioTrack()

    mdhd = _find(buf, mdia[0], mdia[1], b"mdhd")
    timescale = 0
    if mdhd is not None:
        ver, _, pos = _full_box(buf, mdhd[0])
        timescale = struct.unpack_from(">I", buf, pos + (16 if ver == 1 else 8))[0]

    stsd = _find(buf, stbl[0], stbl[1], b"stsd")
    if stsd is None:
        return None
    _parse_stsd(buf, stsd[0], stsd[1], track)
    if track.sample_rate <= 0:
        track.sample_rate = float(timescale)

    if not _parse_tables(buf, stbl, track):
        return None
    return track


def _parse_tables(buf, stbl, track) -> bool:
    """Fill sample_sizes / chunk_offsets / samples_per_chunk from stbl."""
    stsz = _find(buf, stbl[0], stbl[1], b"stsz")
    if stsz is None:
        return False
    _, _, pos = _full_box(buf, stsz[0])
    fixed_size, count = struct.unpack_from(">II", buf, pos)
    if fixed_size:
        track.sample_sizes = np.full(count, fixed_size, np.int64)
    else:
        track.sample_sizes = _read_u32s(buf, pos + 8, count)

    stco = _find(buf, stbl[0], stbl[1], b"stco")
    if stco is not None:
        _, _, pos = _full_box(buf, stco[0])
        n = struct.unpack_from(">I", buf, pos)[0]
        track.chunk_offsets = _read_u32s(buf, pos + 4, n)
    else:
        co64 = _find(buf, stbl[0], stbl[1], b"co64")
        if co64 is None:
            return False
        _, _, pos = _full_box(buf, co64[0])
        n = struct.unpack_from(">I", buf, pos)[0]
        track.chunk_offsets = _read_u64s(buf, pos + 4, n)

    stsc = _find(buf, stbl[0], stbl[1], b"stsc")
    if stsc is None:
        return False
    _, _, pos = _full_box(buf, stsc[0])
    n_ent = struct.unpack_from(">I", buf, pos)[0]
    ent = _read_u32s(buf, pos + 4, n_ent * 3).reshape(n_ent, 3)
    n_chunks = len(track.chunk_offsets)
    spc = np.zeros(n_chunks, np.int64)
    for i in range(n_ent):
        first = int(ent[i, 0]) - 1
        last = int(ent[i + 1, 0]) - 1 if i + 1 < n_ent else n_chunks
        spc[first:last] = int(ent[i, 1])
    track.samples_per_chunk = spc
    return True


def _sample_ranges(track) -> np.ndarray:
    """[n_samples, 2] absolute (start, end) byte offsets per sample."""
    sizes = track.sample_sizes
    starts = np.zeros(len(sizes), np.int64)
    si = 0
    for ci, off in enumerate(track.chunk_offsets):
        n = min(int(track.samples_per_chunk[ci]), len(sizes) - si)
        if n <= 0:
            break
        csizes = sizes[si : si + n]
        starts[si : si + n] = int(off) + np.concatenate(
            [[0], np.cumsum(csizes[:-1])]
        )
        si += n
    ends = starts + sizes
    return np.stack([starts[:si], ends[:si]], axis=1) if si else np.zeros((0, 2), np.int64)


def _gather_samples(buf, track: _AudioTrack) -> bytes:
    """Concatenate the track's sample bytes in chunk order."""
    sizes = track.sample_sizes
    parts: List[bytes] = []
    si = 0
    for ci, off in enumerate(track.chunk_offsets):
        n = int(track.samples_per_chunk[ci])
        n = min(n, len(sizes) - si)
        if n <= 0:
            break
        nbytes = int(sizes[si : si + n].sum())
        parts.append(bytes(buf[int(off) : int(off) + nbytes]))
        si += n
    return b"".join(parts)


_JPEG_FOURCCS = {b"jpeg", b"mjpa", b"mjpb"}


class _VideoTrack:
    fourcc: bytes
    width: int
    height: int
    fps: float
    sample_sizes: np.ndarray
    chunk_offsets: np.ndarray
    samples_per_chunk: np.ndarray


def _parse_video_track(buf, trak_s: int, trak_e: int) -> Optional[_VideoTrack]:
    mdia = _find(buf, trak_s, trak_e, b"mdia")
    if mdia is None:
        return None
    hdlr = _find(buf, mdia[0], mdia[1], b"hdlr")
    if hdlr is None:
        return None
    _, _, hpos = _full_box(buf, hdlr[0])
    if bytes(buf[hpos + 4 : hpos + 8]) != b"vide":
        return None
    stbl = _find_path(buf, mdia[0], mdia[1], [b"minf", b"stbl"])
    if stbl is None:
        return None
    track = _VideoTrack()

    stsd = _find(buf, stbl[0], stbl[1], b"stsd")
    if stsd is None:
        return None
    _, _, pos = _full_box(buf, stsd[0])
    pos += 4  # entry_count
    track.fourcc = bytes(buf[pos + 4 : pos + 8])
    # VisualSampleEntry: +8 size/fourcc, +8 reserved/dref,
    # +16 pre_defined/reserved -> width(2) height(2)
    track.width = struct.unpack_from(">H", buf, pos + 32)[0]
    track.height = struct.unpack_from(">H", buf, pos + 34)[0]

    timescale = 0
    mdhd = _find(buf, mdia[0], mdia[1], b"mdhd")
    if mdhd is not None:
        ver, _, mpos = _full_box(buf, mdhd[0])
        timescale = struct.unpack_from(">I", buf, mpos + (16 if ver == 1 else 8))[0]
    delta = 1
    stts = _find(buf, stbl[0], stbl[1], b"stts")
    if stts is not None:
        _, _, tpos = _full_box(buf, stts[0])
        n_ent = struct.unpack_from(">I", buf, tpos)[0]
        if n_ent:
            delta = struct.unpack_from(">II", buf, tpos + 4)[1] or 1
    track.fps = (timescale / delta) if timescale else 30.0

    if not _parse_tables(buf, stbl, track):
        return None
    return track


class Mp4VideoReader:
    """VideoReader over an MJPEG track in an MP4/MOV container.

    Motion-JPEG samples are standalone JPEG images — decodable with
    imageio/PIL alone, which makes this the container-video ingest path
    available in a codec-less environment (H.264/HEVC tracks raise with
    one-line transcode advice). The reference decoded via cv2/ffmpeg
    (extractors.py:307-309)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        try:
            size = os.fstat(self._fh.fileno()).st_size
            if size < 16:
                raise Mp4Error(f"{path!r}: too small to be an MP4")
            self._buf = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError) as e:
            self._fh.close()
            if isinstance(e, Mp4Error):
                raise
            raise Mp4Error(f"{path!r}: cannot map container: {e}") from e
        try:
            moov = _find(self._buf, 0, size, b"moov")
            if moov is None:
                raise Mp4Error(f"{path!r}: no moov box (not an MP4?)")
            track = None
            for t, s, e in _iter_boxes(self._buf, moov[0], moov[1]):
                if t == b"trak":
                    track = _parse_video_track(self._buf, s, e)
                    if track is not None:
                        break
        except (struct.error, ValueError, IndexError) as e:
            # truncated/corrupt sample tables must surface as Mp4Error so
            # callers (open_video fallback, per-item sweep isolation) can
            # handle them uniformly
            self.close()
            raise Mp4Error(f"{path!r}: malformed container: {e}") from e
        except Mp4Error:
            self.close()
            raise
        if track is None:
            self.close()
            raise Mp4NoVideoTrack(f"{path!r}: no video track in container")
        if track.fourcc not in _JPEG_FOURCCS:
            self.close()
            raise Mp4UnsupportedCodec(
                f"{path!r}: video codec {track.fourcc!r} needs a decoder this "
                "environment lacks — transcode once with "
                "`ffmpeg -i in.mp4 -c:v mjpeg -q:v 3 -c:a pcm_s16le out.mov` "
                "(or to .y4m + .wav)"
            )
        try:
            # imported once the track is known to be MJPEG: without
            # imageio the track is one this environment cannot decode, and
            # open_video falls back to OpenCV as for any other codec
            import imageio.v3 as iio
        except ImportError as e:
            self.close()
            raise Mp4UnsupportedCodec(
                f"{path!r}: decoding the MJPEG track needs imageio, which "
                "is not installed") from e
        self._iio = iio
        try:
            self._ranges = _sample_ranges(track)
        except (struct.error, ValueError, IndexError) as e:
            self.close()
            raise Mp4Error(f"{path!r}: malformed sample tables: {e}") from e
        self.width = track.width
        self.height = track.height
        self.fps = track.fps
        self.n_frames = len(self._ranges)

    def _decode(self, i: int) -> np.ndarray:
        s, e = self._ranges[int(i)]
        frame = self._iio.imread(bytes(self._buf[int(s) : int(e)]), extension=".jpg")
        if frame.ndim == 2:
            frame = np.repeat(frame[..., None], 3, axis=-1)
        return frame[..., :3]

    def read_frame(self, index: int) -> np.ndarray:
        return self._decode(index)

    def read_frames(self, indices) -> np.ndarray:
        return np.stack([self._decode(i) for i in indices])

    def iter_frames(self, start: int = 0, stop: Optional[int] = None):
        stop = self.n_frames if stop is None else min(stop, self.n_frames)
        for i in range(start, stop):
            yield self._decode(i)

    def close(self) -> None:
        try:
            self._buf.close()
        finally:
            self._fh.close()


def extract_audio(path: str) -> Tuple[np.ndarray, int]:
    """MP4/MOV -> (float32 samples [T, C] in [-1, 1], sample_rate).

    Raises Mp4NoAudioTrack if the container carries no audio, and
    Mp4UnsupportedCodec for compressed tracks (AAC etc.).
    """
    with open(path, "rb") as fh:
        size = os.fstat(fh.fileno()).st_size
        if size < 16:
            raise Mp4Error(f"{path!r}: too small to be an MP4")
        buf = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            moov = _find(buf, 0, size, b"moov")
            if moov is None:
                raise Mp4Error(f"{path!r}: no moov box (not an MP4?)")
            track = None
            try:
                for t, s, e in _iter_boxes(buf, moov[0], moov[1]):
                    if t == b"trak":
                        track = _parse_track(buf, s, e)
                        if track is not None:
                            break
            except (struct.error, ValueError, IndexError) as e:
                raise Mp4Error(f"{path!r}: malformed container: {e}") from e
            if track is None:
                raise Mp4NoAudioTrack(f"{path!r}: no audio track in container")
            codec = _PCM_CODECS.get(track.fourcc)
            if codec is None:
                raise Mp4UnsupportedCodec(
                    f"{path!r}: audio codec {track.fourcc!r} needs a decoder "
                    "this environment lacks — provide a <stem>.wav sidecar "
                    "(the paired-audio convention) instead"
                )
            try:
                raw = _gather_samples(buf, track)
            except (struct.error, ValueError, IndexError) as e:
                raise Mp4Error(f"{path!r}: malformed sample data: {e}") from e
        finally:
            buf.close()

    dtype, is_float = codec
    frames = np.frombuffer(raw, dtype=dtype)
    ch = max(track.channels, 1)
    frames = frames[: (len(frames) // ch) * ch].reshape(-1, ch)
    if is_float:
        samples = frames.astype(np.float32)
    else:
        samples = frames.astype(np.float32) / float(
            2 ** (8 * frames.dtype.itemsize - 1)
        )
    return samples, int(round(track.sample_rate))


def load_mp4_audio_mono_16k(path: str) -> np.ndarray:
    """One-call mp4 -> mono float32 @16 kHz (pydub-chain equivalent,
    extractors.py:364-386)."""
    from avsum_torch.io.wav import resample, to_mono

    samples, rate = extract_audio(path)
    return resample(to_mono(samples), rate, 16000)
