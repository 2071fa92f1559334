"""Device milliseconds of the visual backbone (``vision/``) per embedded
frame: the kernels the trace links, by correlation, to launches made
inside an ``avsum.visual_dispatch`` span, over the frames sampled for
embedding in the traced window."""

from benchmark.readers import kernels_launched_in


def read(run):
    frames = run.window_result.counts.get("embedded_frames", 0)
    kernels = kernels_launched_in(run, "avsum.visual_dispatch")
    if not frames or not kernels:
        return None
    return 1e3 * sum(k.end - k.start for k in kernels) / 1e9 / frames
