"""Training examples from the feature cache (numpy): the port's own copies
of ``avsum_tpu/data/{cache,batching,splits,tvsum,summe}.py``."""

from avsum_torch.data.cache import FeatureCache

__all__ = ["FeatureCache"]
