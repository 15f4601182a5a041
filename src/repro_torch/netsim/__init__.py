"""Round transports of the port (only the in-memory one so far)."""

from .transport import InMemoryTransport, RoundResult

__all__ = ["InMemoryTransport", "RoundResult"]
