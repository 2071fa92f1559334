"""Device milliseconds a train step of the operations launched inside
``avsum.kda`` (``models/kda.py::KimiDeltaAttention``): Kimi Delta
Attention's forward in every KDA layer of both decoders, the projections,
short convolutions, gates, the chunked core and its kernel's forward
pass, the gated norm and ``o_proj``."""

from benchmark.spans import device_ms_per


def read(run):
    return device_ms_per(run, ["avsum.kda"], "steps")
