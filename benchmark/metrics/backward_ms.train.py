"""Device milliseconds a train step of the operations launched inside
``avsum.backward`` (``train/steps.py``): the gradients, launched from the
autograd engine's thread while the caller's span is open."""

from benchmark.spans import device_ms_per


def read(run):
    return device_ms_per(run, ["avsum.backward"], "steps")
