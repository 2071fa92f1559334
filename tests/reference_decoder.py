"""The plain reference of the scorer with Moonlight-16B-A3B's decoder as
its temporal encoder: forward, masked MSE loss and training step in plain
``torch`` (float32; the caller turns TF32 off). It is the benchmark's
reference, ``benchmark/reference/decoder.py``, whose docstring lists the
equations and every departure from the source; the tests hold the port's
``temporal_encoder: mla_moe`` to it. It imports nothing of the port, of
the JAX package or of JAX.
"""

from benchmark.reference.decoder import (  # noqa: F401
    QUERY_BLOCK,
    attend,
    decoder,
    decoder_specs,
    forward,
    init_leaves,
    leaf_specs,
    mla,
    moe,
    rope_cos_sin,
    route,
    swiglu,
    train_steps,
)
from benchmark.reference.scorer import masked_mse, step_seeds  # noqa: F401
