"""avsum_torch — the PyTorch / CUDA port of ``avsum_tpu`` for NVIDIA Hopper.

The JAX package ``avsum_tpu`` is the reference; each module here names its
counterpart there and is held to it by a CPU parity test
(``tests/test_torch_*.py``). The Pallas TPU kernels on the summarize and
train paths are hand-written CUDA C++ kernels for ``sm_90a`` (``csrc/``),
built at first use by :mod:`avsum_torch.build` and bound with ctypes. Each kernel's
wrapper launches it for a CUDA tensor and runs the plain PyTorch version of
the same math for a CPU tensor.

This package imports ``torch`` and nothing of ``jax``, ``flax``, ``optax``
or ``avsum_tpu``. It keeps its own copies of the JAX package's numpy
modules: the media layer (``io/``), the config dataclasses and their
YAML loader (``train/config.py``) and the feature cache, batching,
splits and dataset parsers (``data/``).

Layout (mirrors ``avsum_tpu``):

- ``ops/``       spectral ops, the log-mel kernel (K1), flash attention:
  forward (K2) and backward (B3 dK/dV, B4 dQ), YUV->RGB
- ``audio/``     VGGish and the 296-d audio front-end
- ``vision/``    ResNet50, InceptionV3, the dual backbone and shot pooling
- ``models/``    self-attention, BiLSTM, the attention encoder, the AVScorer
- ``temporal/``  host shot-boundary helpers, shot <-> annotation alignment
  (numpy)
- ``summary/``   knapsack selection (numpy; a torch DP on the device for
  large problems), evaluation metrics, the canonical protocol, render
- ``io/``        video and audio decode, the native Y4M decoder, synthetic
  media (numpy, ctypes)
- ``data/``      the feature cache, batching, splits, dataset parsers
- ``train/``     train / eval steps and the optax optimizer, checkpoints,
  the trainer
- ``utils/``     the JSONL scalar logger, pinned and asynchronous
  host <-> device copies
- ``pipeline.py``  ``AVPipeline``: summarize (begin / finish), preprocess
- ``serve/``     the HTTP summarization service and the scorer's export
- ``cli/``       ``python -m avsum_torch.cli summarize VIDEO``, ``train``,
  ``serve``, ``export`` and the dataset commands
- ``convert.py`` Flax param trees -> state_dicts
"""

__version__ = "0.1.0"
