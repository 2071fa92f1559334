"""Device milliseconds a train step of the operations launched inside
``avsum.forward`` (``train/steps.py``): the scorer's forward and the
loss."""

from benchmark.spans import device_ms_per


def read(run):
    return device_ms_per(run, ["avsum.forward"], "steps")
