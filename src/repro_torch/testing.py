"""Helpers for holding the port against the JAX reference in tests.

Arrays cross between the two frameworks as numpy arrays.  torch has no
usable uint32 tensors (no shifts on the CPU), so uint32 data — threefry
keys and packed vote words — travels as int64 values (keys) or int32
bit-views (words).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

__all__ = ["to_torch", "to_numpy", "key_to_torch", "requires_cuda",
           "cuda_device"]


def to_torch(x, device="cpu") -> torch.Tensor:
    """numpy/JAX array -> torch tensor; uint32 becomes its int32 bit-view."""
    a = np.array(x)   # a writable host copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor, dtype=None) -> np.ndarray:
    """torch tensor -> numpy; ``dtype=np.uint32`` reinterprets int32 bits."""
    a = t.detach().cpu().numpy()
    if dtype is not None and np.dtype(dtype) == np.uint32:
        return a.view(np.uint32)
    return a if dtype is None else a.astype(dtype)


def key_to_torch(key, device="cpu") -> torch.Tensor:
    """A JAX uint32 key (or stack of keys) -> the port's int64 key."""
    return torch.from_numpy(np.asarray(key).astype(np.int64)).to(device)


#: marker for tests that need the card (registered in tests/conftest.py);
#: such a test also takes the ``cuda_device`` fixture, which skips it on a
#: host without one.  The check runs inside the fixture, never at import,
#: so every pytest worker collects the same tests.
requires_cuda = pytest.mark.requires_cuda


@pytest.fixture
def cuda_device() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (none on this host)")
    return torch.device("cuda")
