"""The config dataclasses and their YAML loader, shared with ``avsum_tpu``
(``avsum_tpu.train.config`` imports no jax)."""

from avsum_tpu.train.config import Config, load_config

__all__ = ["Config", "load_config"]
