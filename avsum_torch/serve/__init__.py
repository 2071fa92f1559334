"""Serving: the HTTP summarization service and the scorer's export."""

from avsum_torch.serve.export import export_scorer, load_scorer
from avsum_torch.serve.server import ServeConfig, SummarizeServer

__all__ = ["ServeConfig", "SummarizeServer", "export_scorer", "load_scorer"]
