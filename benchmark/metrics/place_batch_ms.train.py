"""Device milliseconds a train step of the operations launched inside
``avsum.place_batch`` (``parallel/mesh.py::shard_batch``, called every
step as ``Trainer.fit`` calls it): the batch's host-to-device copies."""

from benchmark.spans import device_ms_per


def read(run):
    return device_ms_per(run, ["avsum.place_batch"], "steps")
