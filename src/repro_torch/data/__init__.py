"""Synthetic training data: the stateless-seekable token pipeline."""
from .synthetic import TokenPipeline

__all__ = ["TokenPipeline"]
