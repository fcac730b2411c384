"""Evaluation metrics and synthetic corpora (copies of the JAX package's
``eval/``)."""

from .metrics import cer, der, wer

__all__ = ["cer", "der", "wer"]
