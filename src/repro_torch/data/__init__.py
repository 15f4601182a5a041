from .federated import partition_dirichlet, partition_iid
from .synthetic import ClassificationData, classification, lm_batches

__all__ = ["ClassificationData", "classification", "lm_batches",
           "partition_dirichlet", "partition_iid"]
