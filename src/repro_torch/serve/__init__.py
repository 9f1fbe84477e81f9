"""The port's serving layer: retrieval serving (``RetrievalService``). The
token-serving engine is ROADMAP A10."""

from .retrieval import RetrievalConfig, RetrievalService

__all__ = ["RetrievalConfig", "RetrievalService"]
