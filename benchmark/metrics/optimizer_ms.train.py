"""Device milliseconds a train step of the operations launched inside
``avsum.optimizer`` (``train/steps.py``): the global norm, the clipped
AdamW update and the EMA."""

from benchmark.spans import device_ms_per


def read(run):
    return device_ms_per(run, ["avsum.optimizer"], "steps")
