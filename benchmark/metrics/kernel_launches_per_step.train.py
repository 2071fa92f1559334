"""Kernels the device ran in the traced window, per train step: an exact
count of the launches a step makes (copies and sets left out)."""


def read(run):
    steps = run.window_result.counts.get("steps", 0)
    kernels = run.trace.kernels() if run.trace is not None else []
    if not kernels or not steps:
        return None
    return len(kernels) / steps
