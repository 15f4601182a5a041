"""The serving engine of the port (continuous batching over decode slots)."""

from .engine import Request, ServingEngine

__all__ = ["Request", "ServingEngine"]
