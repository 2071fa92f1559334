"""Minimal ISO-BMFF muxer: MJPEG video + PCM audio in one .mp4/.mov.

Counterpart of :mod:`avsum_torch.io.mp4`'s demuxer. Motion-JPEG + PCM is the
codec pair this codec-less environment can both write AND read (each video
sample is a standalone JPEG; audio is raw interleaved PCM), so container
ingest can be exercised end-to-end without ffmpeg — the same container
flow the reference drove through cv2/pydub (extractors.py:307-309,
364-386).
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

__all__ = ["write_mjpeg_mp4", "write_pcm_mp4", "write_mp3_mp4",
           "write_aac_mp4", "remux_video_with_aac"]


def _box(btype: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + btype + payload


def _full(btype: bytes, ver: int, flags: int, payload: bytes) -> bytes:
    return _box(btype, struct.pack(">I", (ver << 24) | flags) + payload)


_UNITY_MATRIX = struct.pack(
    ">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000
)


def _tkhd(track_id: int, duration: int, width: int = 0, height: int = 0,
          volume: int = 0) -> bytes:
    return _full(
        b"tkhd", 0, 7,
        struct.pack(">IIII", 0, 0, track_id, 0)
        + struct.pack(">I", duration)
        + b"\x00" * 8
        + struct.pack(">HHHH", 0, 0, volume, 0)
        + _UNITY_MATRIX
        + struct.pack(">II", width << 16, height << 16),
    )


def _stbl(stsd_entry: bytes, n_samples: int, delta: int,
          stsc_entries: List[tuple], sample_sizes, chunk_offsets) -> bytes:
    stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1) + stsd_entry)
    stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n_samples, delta))
    stsc = _full(
        b"stsc", 0, 0,
        struct.pack(">I", len(stsc_entries))
        + b"".join(struct.pack(">III", *e) for e in stsc_entries),
    )
    if isinstance(sample_sizes, int):  # constant size
        stsz = _full(b"stsz", 0, 0, struct.pack(">II", sample_sizes, n_samples))
    else:
        stsz = _full(
            b"stsz", 0, 0,
            struct.pack(">II", 0, n_samples)
            + b"".join(struct.pack(">I", s) for s in sample_sizes),
        )
    stco = _full(
        b"stco", 0, 0,
        struct.pack(">I", len(chunk_offsets))
        + b"".join(struct.pack(">I", o) for o in chunk_offsets),
    )
    return _box(b"stbl", stsd + stts + stsc + stsz + stco)


def _minf_dinf() -> bytes:
    url = _full(b"url ", 0, 1, b"")
    return _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1) + url))


def _mdia(timescale: int, duration: int, handler: bytes, hname: bytes,
          header_box: bytes, stbl: bytes) -> bytes:
    mdhd = _full(
        b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, timescale, duration, 0x55C4, 0)
    )
    hdlr = _full(b"hdlr", 0, 0, b"\x00" * 4 + handler + b"\x00" * 12 + hname + b"\x00")
    minf = _box(b"minf", header_box + _minf_dinf() + stbl)
    return _box(b"mdia", mdhd + hdlr + minf)


def _audio_trak(
    track_id: int,
    n_audio: int,
    ch: int,
    rate: int,
    base_offset: int,
    chunk_frames: int = 4096,
    codec: bytes = b"sowt",
) -> bytes:
    """PCM-int16 audio trak (one sample = one all-channel PCM frame)."""
    frame_bytes = 2 * ch
    n_chunks = max(1, -(-n_audio // chunk_frames))
    offsets = [
        base_offset + i * chunk_frames * frame_bytes for i in range(n_chunks)
    ]
    last = n_audio - (n_chunks - 1) * chunk_frames
    stsc = [(1, chunk_frames, 1)]
    if n_chunks == 1:
        stsc = [(1, n_audio, 1)]
    elif last != chunk_frames:
        stsc.append((n_chunks, last, 1))
    stsd_a = (
        struct.pack(">I", 36) + codec
        + b"\x00" * 6 + struct.pack(">H", 1)   # reserved + data_ref_index
        + struct.pack(">HH", 0, 0) + b"\x00" * 4  # version/revision/vendor
        + struct.pack(">HH", ch, 16)           # channels, bits
        + struct.pack(">HH", 0, 0)             # predefined, reserved
        + struct.pack(">I", rate << 16)        # 16.16 fixed rate
    )
    stbl_a = _stbl(stsd_a, n_audio, 1, stsc, frame_bytes, offsets)
    smhd = _full(b"smhd", 0, 0, struct.pack(">HH", 0, 0))
    return _box(
        b"trak",
        _tkhd(track_id, int(round(n_audio / rate * 1000)), volume=0x0100)
        + _mdia(rate, n_audio, b"soun", b"SoundHandler", smhd, stbl_a),
    )


def _mp4_descriptor(tag: int, payload: bytes) -> bytes:
    """MPEG-4 BaseDescriptor with expandable length (14496-1 §8.3.3)."""
    size = len(payload)
    enc = bytes([size & 0x7F])
    size >>= 7
    while size:
        enc = bytes([0x80 | (size & 0x7F)]) + enc
        size >>= 7
    return bytes([tag]) + enc + payload


def _esds(object_type: int, avg_bitrate: int,
          decoder_specific: bytes = b"") -> bytes:
    """esds box for an MPEG-4 audio sample entry. ``object_type`` is the
    objectTypeIndication (0x6B = MPEG-1 audio/MP3, 0x40 = AAC)."""
    dec_specific = (
        _mp4_descriptor(0x05, decoder_specific) if decoder_specific else b""
    )
    dec_config = _mp4_descriptor(
        0x04,
        bytes([object_type, 0x15])          # streamType=audio, upStream=0
        + b"\x00\x00\x00"                    # bufferSizeDB
        + struct.pack(">II", avg_bitrate, avg_bitrate)
        + dec_specific,
    )
    sl_config = _mp4_descriptor(0x06, b"\x02")
    es = _mp4_descriptor(0x03, struct.pack(">HB", 1, 0) + dec_config + sl_config)
    return _full(b"esds", 0, 0, es)


def _mp4a_trak(
    track_id: int,
    sizes: List[int],
    ch: int,
    rate: int,
    samples_per_frame: int,
    base_offset: int,
    object_type: int,
    decoder_specific: bytes = b"",
) -> bytes:
    """Compressed-audio trak: 'mp4a' sample entry + esds, one codec frame
    per sample (timescale = the stream's sample rate)."""
    total_samples = len(sizes) * samples_per_frame
    avg_bitrate = int(sum(sizes) * 8 * rate / max(total_samples, 1))
    esds = _esds(object_type, avg_bitrate, decoder_specific)
    stsd_a = (
        struct.pack(">I", 36 + len(esds)) + b"mp4a"
        + b"\x00" * 6 + struct.pack(">H", 1)
        + struct.pack(">HH", 0, 0) + b"\x00" * 4
        + struct.pack(">HH", ch, 16)
        + struct.pack(">HH", 0, 0)
        + struct.pack(">I", rate << 16)
        + esds
    )
    offsets = [base_offset + int(o) for o in
               np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64)]
    stbl_a = _stbl(
        stsd_a, len(sizes), samples_per_frame, [(1, 1, 1)], sizes, offsets
    )
    smhd = _full(b"smhd", 0, 0, struct.pack(">HH", 0, 0))
    return _box(
        b"trak",
        _tkhd(track_id, int(round(total_samples / rate * 1000)),
              volume=0x0100)
        + _mdia(rate, total_samples, b"soun", b"SoundHandler", smhd, stbl_a),
    )


def write_mp3_mp4(
    path: str,
    mp3_bytes: bytes,
    frames: Optional[np.ndarray] = None,
    fps: float = 30.0,
    quality: int = 92,
) -> None:
    """Mux an MP3 elementary stream (optionally plus MJPEG video
    ``frames`` [T, H, W, 3] uint8) into an ISO-BMFF container as a real
    compressed 'mp4a' track (esds objectTypeIndication 0x6B).

    The native demuxer rejects this codec (``Mp4UnsupportedCodec``), so
    such files exercise the bundled-ffmpeg fallback the way real-dataset
    AAC mp4s do (reference extract path: extractors.py:364-386).
    """
    from avsum_torch.io.mp3 import parse_mp3

    stream = parse_mp3(mp3_bytes)
    _write_compressed_audio_mp4(
        path, stream.frames, stream.channels, stream.sample_rate,
        stream.samples_per_frame, 0x6B, b"", frames, fps, quality)


def write_aac_mp4(
    path: str,
    samples: np.ndarray,
    rate: int = 16000,
    frames: Optional[np.ndarray] = None,
    fps: float = 30.0,
    quality: int = 92,
    bit_rate: int = 96000,
) -> None:
    """Encode mono float32 ``samples`` with the bundled AAC encoder and
    mux them (optionally plus MJPEG video) as a real 'mp4a'/AAC-LC track
    (esds objectTypeIndication 0x40 + AudioSpecificConfig) — the exact
    shape of real TVSum/SumMe dataset files the reference consumed
    (extractors.py:364-386). Requires ``ffaudio.aac_encode_available()``.
    """
    from avsum_torch.io.ffaudio import AAC_SAMPLES_PER_FRAME, encode_aac

    packets, asc = encode_aac(samples, rate, bit_rate=bit_rate)
    _write_compressed_audio_mp4(
        path, packets, 1, rate, AAC_SAMPLES_PER_FRAME, 0x40, asc,
        frames, fps, quality)


def _write_compressed_audio_mp4(
    path: str,
    audio_frames: List[bytes],
    channels: int,
    rate: int,
    samples_per_frame: int,
    object_type: int,
    decoder_specific: bytes,
    frames: Optional[np.ndarray],
    fps: float,
    quality: int,
) -> None:
    audio_bytes = b"".join(audio_frames)
    n_samples = len(audio_frames) * samples_per_frame

    jpegs: List[bytes] = []
    if frames is not None:
        import imageio.v3 as iio

        frames = np.asarray(frames)
        jpegs = [
            iio.imwrite("<bytes>", frames[i], extension=".jpg",
                        quality=quality)
            for i in range(frames.shape[0])
        ]
    video_bytes = b"".join(jpegs)

    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 0x200) + b"isomiso2mp41")
    mdat = _box(b"mdat", video_bytes + audio_bytes)
    video_base = len(ftyp) + 8
    audio_base = video_base + len(video_bytes)

    traks = b""
    movie_dur = int(round(n_samples / rate * 1000))
    next_id = 1
    if jpegs:
        t, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
        stsd_v = (
            struct.pack(">I", 86) + b"jpeg"
            + b"\x00" * 6 + struct.pack(">H", 1)
            + b"\x00" * 16
            + struct.pack(">HH", w, h)
            + struct.pack(">II", 0x480000, 0x480000)
            + struct.pack(">I", 0)
            + struct.pack(">H", 1)
            + b"\x00" * 32
            + struct.pack(">Hh", 24, -1)
        )
        sizes = [len(j) for j in jpegs]
        offs = [video_base + int(o) for o in
                np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64)]
        stbl_v = _stbl(stsd_v, t, 1000, [(1, 1, 1)], sizes, offs)
        vmhd = _full(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
        traks += _box(
            b"trak",
            _tkhd(1, int(round(t / fps * 1000)), width=w, height=h)
            + _mdia(max(1, round(fps * 1000)), t * 1000, b"vide",
                    b"VideoHandler", vmhd, stbl_v),
        )
        movie_dur = max(movie_dur, int(round(t / fps * 1000)))
        next_id = 2

    traks += _mp4a_trak(
        next_id, [len(f) for f in audio_frames], channels, rate,
        samples_per_frame, audio_base, object_type, decoder_specific
    )

    mvhd = _full(
        b"mvhd", 0, 0,
        struct.pack(">IIII", 0, 0, 1000, movie_dur)
        + struct.pack(">IH", 0x10000, 0x0100) + b"\x00" * 10
        + _UNITY_MATRIX
        + b"\x00" * 24 + struct.pack(">I", next_id + 1),
    )
    moov = _box(b"moov", mvhd + traks)
    with open(path, "wb") as fh:
        fh.write(ftyp + mdat + moov)


def remux_video_with_aac(
    src_path: str,
    out_path: str,
    samples: np.ndarray,
    rate: int = 16000,
    bit_rate: int = 96000,
) -> None:
    """Copy ``src_path``'s video track VERBATIM (any codec — mp4v, H.264,
    MJPEG, ...; no re-encode) into a new container and add an AAC-LC
    audio track encoded from mono float32 ``samples``.

    This produces the exact shape of real TVSum/SumMe dataset files —
    one mp4 holding a compressed video track the native demuxer rejects
    (``Mp4UnsupportedCodec`` -> cv2/ffmpeg fallback) plus an AAC 'mp4a'
    track (-> bundled-ffmpeg audio fallback) — the container ingest the
    reference fed to cv2/librosa (extractors.py:307-309, 364-386).
    The video sample entry (stsd, including any esds/avcC decoder
    config) is copied byte-for-byte; sample timing keeps the source's
    stts verbatim.
    """
    import mmap as _mmap

    from avsum_torch.io.ffaudio import AAC_SAMPLES_PER_FRAME, encode_aac
    from avsum_torch.io.mp4 import (
        Mp4Error,
        Mp4NoVideoTrack,
        _find,
        _find_path,
        _full_box,
        _gather_samples,
        _iter_boxes,
        _parse_video_track,
    )

    with open(src_path, "rb") as fh:
        buf = _mmap.mmap(fh.fileno(), 0, access=_mmap.ACCESS_READ)
        try:
            size = len(buf)
            moov = _find(buf, 0, size, b"moov")
            if moov is None:
                raise Mp4Error(f"{src_path!r}: no moov box")
            track = stbl = mdia = None
            for t, s, e in _iter_boxes(buf, moov[0], moov[1]):
                if t == b"trak":
                    track = _parse_video_track(buf, s, e)
                    if track is not None:
                        mdia = _find(buf, s, e, b"mdia")
                        stbl = _find_path(
                            buf, mdia[0], mdia[1], [b"minf", b"stbl"]
                        )
                        break
            if track is None:
                raise Mp4NoVideoTrack(f"{src_path!r}: no video track")

            # raw VisualSampleEntry (carries esds/avcC decoder config)
            stsd = _find(buf, stbl[0], stbl[1], b"stsd")
            _, _, pos = _full_box(buf, stsd[0])
            pos += 4  # entry_count
            entry_size = struct.unpack_from(">I", buf, pos)[0]
            stsd_entry = bytes(buf[pos : pos + entry_size])

            # source timing, verbatim
            mdhd = _find(buf, mdia[0], mdia[1], b"mdhd")
            ver, _, mpos = _full_box(buf, mdhd[0])
            timescale = struct.unpack_from(
                ">I", buf, mpos + (16 if ver == 1 else 8)
            )[0]
            stts = _find(buf, stbl[0], stbl[1], b"stts")
            _, _, tpos = _full_box(buf, stts[0])
            n_ent = struct.unpack_from(">I", buf, tpos)[0]
            stts_payload = bytes(buf[tpos : tpos + 4 + 8 * n_ent])
            ent = np.frombuffer(
                stts_payload[4:], dtype=">u4"
            ).reshape(n_ent, 2)
            media_dur = int((ent[:, 0].astype(np.int64) * ent[:, 1]).sum())

            # sync-sample table, verbatim (sample numbering is unchanged);
            # dropping it would declare EVERY frame a keyframe and break
            # seek-decode on inter-coded tracks (mp4v/H.264)
            stss_box = b""
            stss = _find(buf, stbl[0], stbl[1], b"stss")
            if stss is not None:
                _, _, spos = _full_box(buf, stss[0])
                n_sync = struct.unpack_from(">I", buf, spos)[0]
                stss_box = _full(
                    b"stss", 0, 0, bytes(buf[spos : spos + 4 + 4 * n_sync])
                )

            video_bytes = _gather_samples(buf, track)
            sizes_v = [int(s) for s in track.sample_sizes]
        finally:
            buf.close()

    packets, asc = encode_aac(samples, rate, bit_rate=bit_rate)

    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 0x200) + b"isomiso2mp41")
    mdat = _box(b"mdat", video_bytes + b"".join(packets))
    video_base = len(ftyp) + 8
    audio_base = video_base + len(video_bytes)

    # video trak: copied sample entry + verbatim stts, samples re-laid
    # out as one contiguous chunk
    stsd_v = _full(b"stsd", 0, 0, struct.pack(">I", 1) + stsd_entry)
    stts_v = _full(b"stts", 0, 0, stts_payload)
    stsc_v = _full(
        b"stsc", 0, 0,
        struct.pack(">I", 1) + struct.pack(">III", 1, len(sizes_v), 1),
    )
    stsz_v = _full(
        b"stsz", 0, 0,
        struct.pack(">II", 0, len(sizes_v))
        + b"".join(struct.pack(">I", s) for s in sizes_v),
    )
    stco_v = _full(b"stco", 0, 0, struct.pack(">II", 1, video_base))
    stbl_v = _box(
        b"stbl", stsd_v + stts_v + stsc_v + stsz_v + stco_v + stss_box
    )
    vmhd = _full(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
    movie_dur_v = int(round(media_dur / max(timescale, 1) * 1000))
    trak_v = _box(
        b"trak",
        _tkhd(1, movie_dur_v, width=track.width, height=track.height)
        + _mdia(timescale, media_dur, b"vide", b"VideoHandler", vmhd, stbl_v),
    )

    trak_a = _mp4a_trak(
        2, [len(p) for p in packets], 1, rate, AAC_SAMPLES_PER_FRAME,
        audio_base, 0x40, asc,
    )
    n_audio_samples = len(packets) * AAC_SAMPLES_PER_FRAME
    movie_dur = max(movie_dur_v, int(round(n_audio_samples / rate * 1000)))
    mvhd = _full(
        b"mvhd", 0, 0,
        struct.pack(">IIII", 0, 0, 1000, movie_dur)
        + struct.pack(">IH", 0x10000, 0x0100) + b"\x00" * 10
        + _UNITY_MATRIX
        + b"\x00" * 24 + struct.pack(">I", 3),
    )
    moov = _box(b"moov", mvhd + trak_v + trak_a)
    with open(out_path, "wb") as fh:
        fh.write(ftyp + mdat + moov)


def _quantize_pcm(samples: np.ndarray) -> np.ndarray:
    """[T] or [T, C] float in [-1, 1] (or int16) -> int16 [T, C]."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    if x.dtype != np.int16:
        x = (np.clip(np.asarray(x, np.float32), -1, 1) * 32767).astype(np.int16)
    return x


def write_pcm_mp4(
    path: str,
    samples: np.ndarray,
    rate: int = 16000,
    chunk_frames: int = 4096,
    codec: str = "sowt",
) -> None:
    """Write an audio-only ISO-BMFF (.mp4/.mov) with an uncompressed PCM
    track — the test/synthesis counterpart of :mod:`avsum_torch.io.mp4`'s
    demuxer (in-container audio like the reference's mp4s carried,
    extractors.py:364-386, but PCM so it is decodable without codecs).

    ``samples``: [T] or [T, C] float32 in [-1, 1] (int16-quantized) or
    int16. ``codec``: 'sowt' (LE int16) or 'twos' (BE int16).
    """
    x = _quantize_pcm(samples)
    n, ch = x.shape
    pcm = x.astype("<i2" if codec == "sowt" else ">i2").tobytes()

    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 0x200) + b"isomiso2mp41")
    mdat = _box(b"mdat", pcm)
    trak = _audio_trak(
        1, n, ch, rate, len(ftyp) + 8, chunk_frames, codec.encode()
    )
    mvhd = _full(
        b"mvhd", 0, 0,
        struct.pack(">IIII", 0, 0, 1000, int(round(n / rate * 1000)))
        + struct.pack(">IH", 0x10000, 0x0100) + b"\x00" * 10
        + _UNITY_MATRIX
        + b"\x00" * 24 + struct.pack(">I", 2),
    )
    moov = _box(b"moov", mvhd + trak)
    with open(path, "wb") as fh:
        fh.write(ftyp + mdat + moov)


def write_mjpeg_mp4(
    path: str,
    frames: np.ndarray,
    fps: float = 30.0,
    audio: Optional[np.ndarray] = None,
    audio_rate: int = 16000,
    quality: int = 92,
) -> None:
    """Write [T, H, W, 3] uint8 frames as an MJPEG track (+ optional mono/
    stereo PCM ``audio`` in [-1, 1] float or int16) into one container."""
    import imageio.v3 as iio

    frames = np.asarray(frames)
    t, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
    jpegs = [
        iio.imwrite("<bytes>", frames[i], extension=".jpg", quality=quality)
        for i in range(t)
    ]

    pcm = b""
    n_audio = 0
    ch = 1
    if audio is not None:
        x = _quantize_pcm(audio)
        n_audio, ch = x.shape
        pcm = x.astype("<i2").tobytes()

    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 0x200) + b"isomiso2mp41")
    video_bytes = b"".join(jpegs)
    mdat = _box(b"mdat", video_bytes + pcm)
    video_base = len(ftyp) + 8
    audio_base = video_base + len(video_bytes)

    vts = max(1, round(fps * 1000))
    vdelta = 1000
    vdur = t * vdelta  # media-timescale ticks (mdhd)
    movie_dur = int(round(t / fps * 1000))  # movie-timescale (tkhd/mvhd)

    # VisualSampleEntry for 'jpeg'
    stsd_v = (
        struct.pack(">I", 86) + b"jpeg"
        + b"\x00" * 6 + struct.pack(">H", 1)        # reserved + dref index
        + b"\x00" * 16                                # pre_defined/reserved
        + struct.pack(">HH", w, h)
        + struct.pack(">II", 0x480000, 0x480000)      # 72 dpi
        + struct.pack(">I", 0)
        + struct.pack(">H", 1)                        # frame count
        + b"\x00" * 32                                # compressor name
        + struct.pack(">Hh", 24, -1)                  # depth, pre_defined
    )
    sizes = [len(j) for j in jpegs]
    offsets = list(video_base + np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64))
    stbl_v = _stbl(stsd_v, t, vdelta, [(1, 1, 1)], sizes, [int(o) for o in offsets])
    vmhd = _full(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
    trak_v = _box(
        b"trak",
        _tkhd(1, movie_dur, width=w, height=h)
        + _mdia(vts, vdur, b"vide", b"VideoHandler", vmhd, stbl_v),
    )

    traks = trak_v
    if audio is not None and n_audio:
        traks += _audio_trak(2, n_audio, ch, audio_rate, audio_base)

    mvhd = _full(
        b"mvhd", 0, 0,
        struct.pack(">IIII", 0, 0, 1000, int(round(t / fps * 1000)))
        + struct.pack(">IH", 0x10000, 0x0100) + b"\x00" * 10
        + _UNITY_MATRIX
        + b"\x00" * 24 + struct.pack(">I", 3),
    )
    moov = _box(b"moov", mvhd + traks)
    with open(path, "wb") as fh:
        fh.write(ftyp + mdat + moov)
