"""The port's serving layer: the batched prefill/decode engine
(``ServeEngine``) and retrieval serving (``RetrievalService``)."""

from .engine import ServeConfig, ServeEngine
from .retrieval import RetrievalConfig, RetrievalService

__all__ = ["RetrievalConfig", "RetrievalService", "ServeConfig", "ServeEngine"]
