"""The plain reference of the scorer with Kimi-Linear-48B-A3B's decoder as
its temporal encoder: forward, masked MSE loss and training step in plain
``torch`` (float32; the caller turns TF32 off), Kimi Delta Attention's
recurrence token by token. It is the benchmark's reference,
``benchmark/reference/kimi_linear.py``, whose docstring lists the
equations and every departure from the source; the tests hold the port's
hybrid decoder (``model.kda_layers``) to it. It imports nothing of the
port, of the JAX package or of JAX.
"""

from benchmark.reference.kimi_linear import (  # noqa: F401
    BLOCK,
    causal_conv,
    decoder_forward,
    first_kda_input,
    forward,
    init_leaves,
    kda,
    kda_recurrence,
    l2_norm,
    leaf_specs,
    train_steps,
)
from benchmark.reference.scorer import masked_mse, step_seeds  # noqa: F401
