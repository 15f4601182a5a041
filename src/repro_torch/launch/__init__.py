"""Launchers: the mesh description and the train and serve entry points.

Run them as modules (``python -m repro_torch.launch.train``,
``python -m repro_torch.launch.serve``).  The reference's ``dryrun`` and
``hlo_cost`` (lowering and costing XLA HLO for the 512-chip mesh) are not
ported yet (ROADMAP queue A); nothing here imports them.
"""

from .mesh import (DEVICE, HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_FP32, Mesh,
                   make_production_mesh, make_test_mesh)

__all__ = ["Mesh", "make_production_mesh", "make_test_mesh", "DEVICE",
           "PEAK_FLOPS_BF16", "PEAK_FLOPS_FP32", "HBM_BW"]
