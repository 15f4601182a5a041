"""The FL simulator of the port (in-memory transport, FediAC aggregator)
and the serving steps (:mod:`.serve`)."""

from .fl_loop import FLConfig, FLHistory, RoundRecord, run_federated

__all__ = ["FLConfig", "FLHistory", "RoundRecord", "run_federated"]
