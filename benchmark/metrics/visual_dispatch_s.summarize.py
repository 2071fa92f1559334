"""Seconds the pipeline's dispatch loop (``pipeline.py``: reading the
sampled frames, uploading them, enqueueing their embedding) held the
calling thread a video: the ``avsum.visual_dispatch`` span's seconds
over the traced window, per completed video."""


def read(run):
    videos = run.window_result.counts.get("videos", 0)
    spent = run.window_result.spans.get("avsum.visual_dispatch")
    if not videos or spent is None:
        return None
    return spent / videos
