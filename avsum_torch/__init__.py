"""avsum_torch — the PyTorch / CUDA port of ``avsum_tpu`` for NVIDIA Hopper.

The JAX package ``avsum_tpu`` is the reference; each module here names its
counterpart there and is held to it by a CPU parity test
(``tests/test_torch_*.py``). The Pallas TPU kernels on the summarize and
train paths are hand-written CUDA C++ kernels for ``sm_90a`` (``csrc/``),
built at first use by :mod:`avsum_torch.build` and bound with ctypes. Each kernel's
wrapper launches it for a CUDA tensor and runs the plain PyTorch version of
the same math for a CPU tensor.

This package imports ``torch`` and never ``jax`` or ``flax``. From
``avsum_tpu`` it imports only the numpy/ctypes media layer (``io``), the
config dataclasses (``train.config``) and the numpy data modules
(``data.batching``, ``cache``, ``splits``, ``tvsum``, ``summe``,
``synthetic``); ``avsum_tpu.utils`` is out of reach, because its package
``__init__`` imports jax.

Layout (mirrors ``avsum_tpu``):

- ``ops/``       spectral ops, the log-mel kernel (K1), flash attention:
  forward (K2) and backward (B3 dK/dV, B4 dQ), YUV->RGB
- ``audio/``     VGGish and the 296-d audio front-end
- ``vision/``    ResNet50, InceptionV3, the dual backbone and shot pooling
- ``models/``    self-attention, BiLSTM, the attention encoder, the AVScorer
- ``temporal/``  host shot-boundary helpers, shot <-> annotation alignment
  (numpy)
- ``summary/``   knapsack selection and evaluation metrics (numpy)
- ``data/``      training examples from the feature cache
- ``train/``     train / eval steps and the optax optimizer, checkpoints,
  the trainer
- ``utils/``     the JSONL scalar logger
- ``pipeline.py``  ``AVPipeline.summarize``
- ``cli/``       ``python -m avsum_torch.cli summarize VIDEO`` and ``train``
- ``convert.py`` Flax param trees -> state_dicts
"""

__version__ = "0.1.0"
