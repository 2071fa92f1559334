"""Seconds the host's detect thread (decode and shot detection,
``io/native.py`` over ``native/avsumio.cc``) ran a video: the
``avsum.detect_thread`` span's seconds over the traced window, per
completed video."""


def read(run):
    videos = run.window_result.counts.get("videos", 0)
    spent = run.window_result.spans.get("avsum.detect_thread")
    if not videos or spent is None:
        return None
    return spent / videos
