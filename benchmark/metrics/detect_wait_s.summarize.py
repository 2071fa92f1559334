"""Seconds the finisher blocked joining the detect thread a video
(``pipeline.py::_finish_prep``): the ``avsum.detect_join`` span's seconds
over the traced window, per completed video."""

from benchmark.spans import span_s_per_video


def read(run):
    return span_s_per_video(run, "avsum.detect_join")
