"""Client-axis aggregation of the quantized contributions: the plain sum
and the trimmed-mean / median closes of each consensus slot.

* ``"sum"``: the paper's plain integer addition (the default; the call
  sites' ``/(n * f)`` with a Python int ``n`` is the pre-robust
  expression, bitwise);
* ``"trim"``: drop the ``t`` smallest and ``t`` largest live values of each
  slot, ``t = floor(trim_frac * n_live)`` clamped so that at least one
  value survives, and sum the rest;
* ``"median"``: the maximal trim, ``t = (n_live - 1) // 2``.

Ties break by client index: values sort ascending with a stable argsort,
and dead rows carry the dtype-max sentinel, which places them after every
live value.  The sums stay int32 (torch would promote them to int64), as
the switch's registers are, and the kept count is a 0-dim int32 tensor on
the values' device, so that the call site's ``/(kept * f)`` divides tensor
by tensor.
"""

from __future__ import annotations

import torch

__all__ = ["ROBUST_AGG_MODES", "trim_count", "trimmed_sum", "client_sum",
           "kept_count"]

#: registered robust aggregation modes (FediACConfig.robust_agg)
ROBUST_AGG_MODES = ("sum", "trim", "median")


def trim_count(mode: str, trim_frac, n_live, *, device=None) -> torch.Tensor:
    """Per-side trim depth ``t`` (int32 0-dim) for ``n_live`` live values.

    ``trim`` takes ``floor(trim_frac * n_live)`` in float32; ``median`` is
    the maximal trim.  Both clamp to ``(n_live - 1) // 2``.  ``device``
    places a result computed from Python numbers (a tensor ``n_live``
    keeps its own).
    """
    n_live = torch.as_tensor(n_live, dtype=torch.int32, device=device)
    max_t = torch.clamp_min(n_live - 1, 0) // 2
    if mode == "median":
        return max_t
    frac = torch.as_tensor(trim_frac, dtype=torch.float32,
                           device=n_live.device)
    t = torch.floor(frac * n_live.to(torch.float32)).to(torch.int32)
    return torch.minimum(torch.clamp_min(t, 0), max_t)


def _sentinel(dtype: torch.dtype):
    """The value a dead row takes: it sorts after every live value."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def trimmed_sum(values: torch.Tensor, live: torch.Tensor, t):
    """Sum each slot's live values with the ``t`` lowest and ``t`` highest
    removed.

    ``values`` ``[N, C]`` per-client slot contributions (int32 on the wire
    paths); ``live`` bool ``[N]``; ``t`` the per-side trim depth.  Returns
    ``(kept_sum [C], kept)``, ``kept = n_live - 2t`` as an int32 0-dim
    tensor.  Ranks come from two stable argsorts (the second inverts the
    first), and the keep mask is ``t <= rank < n_live - t``; at ``t == 0``
    it is exactly ``live``.
    """
    masked = torch.where(live[:, None], values,
                         torch.full((), _sentinel(values.dtype),
                                    dtype=values.dtype, device=values.device))
    order = torch.argsort(masked, dim=0, stable=True)
    rank = torch.argsort(order, dim=0, stable=True)
    n_live = live.sum(dtype=torch.int32)
    t = torch.as_tensor(t, dtype=torch.int32, device=values.device)
    keep = live[:, None] & (rank >= t) & (rank < n_live - t)
    kept_sum = torch.where(keep, values, 0).sum(dim=0, dtype=values.dtype)
    return kept_sum, n_live - 2 * t


def client_sum(q: torch.Tensor, cfg):
    """Aggregate the client axis of ``[N, chunk]`` contributions under
    ``cfg.robust_agg``.  Returns ``(aggregated [chunk], kept)``: ``kept``
    is the Python int N in sum mode and an int32 0-dim tensor on ``q``'s
    device otherwise."""
    n = q.shape[0]
    if cfg.robust_agg == "sum":
        return q.sum(dim=0, dtype=torch.int32), n
    t = trim_count(cfg.robust_agg, cfg.trim_frac, n, device=q.device)
    return trimmed_sum(q, torch.ones((n,), dtype=torch.bool, device=q.device),
                       t)


def kept_count(cfg, n: int, *, device=None):
    """The per-slot kept count of an all-live ``n``-client round, the
    aggregation denominator: the Python int ``n`` in sum mode, an int32
    0-dim tensor on ``device`` otherwise."""
    if cfg.robust_agg == "sum":
        return n
    return n - 2 * trim_count(cfg.robust_agg, cfg.trim_frac, n, device=device)
