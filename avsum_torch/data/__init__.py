"""Training examples from the feature cache (numpy)."""

from avsum_tpu.data.cache import FeatureCache

__all__ = ["FeatureCache"]
