"""The FL simulator of the port (in-memory transport, FediAC aggregator),
the distributed train step (:mod:`.dist_step`) and the serving steps
(:mod:`.serve`)."""

from .dist_step import TrainStepBundle, client_axes_for, make_train_step
from .fl_loop import FLConfig, FLHistory, RoundRecord, run_federated
from .serve import ServeBundle, make_serve_step

__all__ = ["TrainStepBundle", "client_axes_for", "make_train_step",
           "FLConfig", "FLHistory", "RoundRecord", "run_federated",
           "ServeBundle", "make_serve_step"]
