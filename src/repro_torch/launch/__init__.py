"""Launchers: the mesh description, the train and serve entry points,
and the dry-run.

Run them as modules (``python -m repro_torch.launch.train``,
``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.dryrun``).  ``dryrun`` costs every (arch x
input shape) step on ``meta`` tensors with ``op_cost`` (the counterpart
of the reference's ``hlo_cost``: FLOPs, bytes and collective payloads per
executed aten op) and records its roofline terms on the H100; this
package imports neither at import time.
"""

from .mesh import (DEVICE, HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_FP32, Mesh,
                   make_production_mesh, make_test_mesh)

__all__ = ["Mesh", "make_production_mesh", "make_test_mesh", "DEVICE",
           "PEAK_FLOPS_BF16", "PEAK_FLOPS_FP32", "HBM_BW"]
