"""Device milliseconds a train step of the operations launched inside
``avsum.moe`` (``models/decoder.py::SparseMoE``): the router, the sort of
the token-expert pairs, the held experts' products, the combine and the
shared experts, in every MoE layer of both decoders."""

from benchmark.spans import device_ms_per


def read(run):
    return device_ms_per(run, ["avsum.moe"], "steps")
