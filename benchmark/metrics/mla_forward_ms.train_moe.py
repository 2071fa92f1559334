"""Device milliseconds a train step of the operations launched inside
``avsum.mla`` (``models/decoder.py::LatentAttention``): the latent
attention's forward in every layer of both decoders, K2 among them."""

from benchmark.spans import device_ms_per


def read(run):
    return device_ms_per(run, ["avsum.mla"], "steps")
