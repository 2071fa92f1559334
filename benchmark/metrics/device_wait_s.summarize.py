"""Seconds the caller blocked on the device a video: a pinned slot's
event, the counts' copy and the scores' readback (the
``avsum.device_wait`` span's seconds over the traced window, per
completed video)."""

from benchmark.spans import span_s_per_video


def read(run):
    return span_s_per_video(run, "avsum.device_wait")
