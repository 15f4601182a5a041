"""Flat-key npz checkpointing of nested dicts, lists and tuples of tensors.

The format is the reference's: each leaf is stored under its ``/``-joined
path (dict keys in sorted order, sequence indices), the step under
``__step__``, and the file is written to ``<path>.tmp`` and moved into
place with ``os.replace``, so a kill never leaves half a checkpoint.
Tensors are stored as numpy arrays of their own dtype; ``None`` is an
empty subtree, as in a jax pytree.  A checkpoint written by the port and
one written by the reference for the same run hold the same keys, shapes
and dtypes.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.core.pytree import leaves_with_paths, tree_map_with_path

__all__ = ["save_checkpoint", "load_checkpoint", "save_run_state",
           "load_run_state"]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree, step: int | None = None) -> None:
    """Write ``tree`` (and ``step``) to ``path`` atomically."""
    arrays = {"/".join(p): _to_numpy(v) for p, v in leaves_with_paths(tree)}
    if step is not None:
        arrays["__step__"] = np.asarray(step)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, like=None):
    """Restore a checkpoint as ``(tree, step)``.  With ``like`` the tree
    takes its structure (leaves as numpy arrays); without, it is the flat
    ``{path: array}`` dict."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    step = int(arrays.pop("__step__")) if "__step__" in arrays else None
    if like is None:
        return arrays, step
    return tree_map_with_path(lambda p, _: arrays["/".join(p)], like), step


# ---------------------------------------------------------------------------
# round-granular FL run state (crash-safe recovery)
# ---------------------------------------------------------------------------
#
# One record per completed round: everything run_federated threads between
# rounds (model, error-feedback stack, PRNG key, aggregator state, pricing
# accumulators, the history so far).  float32 arrays round-trip exactly
# through npz, and the accumulators and history are stored as float64, the
# precision the Python loop carries them at, so a resumed run continues
# bit for bit.

_HIST_FIELDS = ("acc", "wall_clock", "traffic_mb", "loss")


def save_run_state(path: str, *, flat, e_stack, key, agg_state, round_idx,
                   t_cum, mb_cum, history) -> None:
    """Persist the FL loop's inter-round state after round ``round_idx``.
    ``key`` (the port's int64 ``[0, seed]`` form) is stored as the
    reference's uint32[2]."""
    tree = {
        "flat": _to_numpy(flat),
        "e_stack": _to_numpy(e_stack),
        "key": _to_numpy(key).astype(np.uint32),
        "t_cum": np.float64(t_cum),
        "mb_cum": np.float64(mb_cum),
        "hist": {f: np.asarray(getattr(history, f), np.float64)
                 for f in _HIST_FIELDS},
    }
    if agg_state is not None:
        tree["agg_state"] = agg_state
    save_checkpoint(path, tree, step=round_idx)


def load_run_state(path: str) -> dict:
    """Restore :func:`save_run_state` output as numpy arrays and Python
    numbers: ``flat``, ``e_stack``, ``key`` (uint32[2]), ``agg_state``
    (None, an array or a nested dict), ``round`` (the last completed
    round), ``t_cum``, ``mb_cum`` and ``history`` (one list of floats per
    FLHistory field)."""
    arrays, step = load_checkpoint(path)
    nested: dict = {}
    for k, v in arrays.items():
        parts = k.split("/")
        d = nested
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    hist = nested.pop("hist", {})
    return {
        "flat": nested["flat"],
        "e_stack": nested["e_stack"],
        "key": nested["key"],
        "agg_state": nested.pop("agg_state", None),
        "round": step,
        "t_cum": float(nested["t_cum"]),
        "mb_cum": float(nested["mb_cum"]),
        "history": {f: [float(x) for x in hist.get(f, np.empty(0))]
                    for f in _HIST_FIELDS},
    }
