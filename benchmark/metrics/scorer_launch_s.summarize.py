"""Seconds the caller spent launching the scorer a video (``models/``,
the BiLSTM's host loop in this configuration), its readback left out: the
``avsum.scorer_launch`` span's seconds over the traced window, per
completed video."""

from benchmark.spans import span_s_per_video


def read(run):
    return span_s_per_video(run, "avsum.scorer_launch")
