"""Seconds the caller spent enqueueing the backbones' work a video (the
colour conversion's and both networks' launches, ``vision/backbone.py``):
the ``avsum.embed_enqueue`` span's seconds over the traced window, per
completed video."""

from benchmark.spans import span_s_per_video


def read(run):
    return span_s_per_video(run, "avsum.embed_enqueue")
