"""Seconds the C++ reader held the caller a video in the dispatch loop
(``read_yuv420_packed``, ``io/native.py`` over ``native/avsumio.cc``):
the ``avsum.frame_read`` span's seconds over the traced window, per
completed video."""

from benchmark.spans import span_s_per_video


def read(run):
    return span_s_per_video(run, "avsum.frame_read")
