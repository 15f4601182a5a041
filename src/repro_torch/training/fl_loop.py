"""The federated-learning simulator: N clients, E local steps, the FediAC
in-network aggregator, and the M/G/1 switch wall-clock model.

The task model is a small MLP classifier over the synthetic non-IID
classification data, as in the reference.  Local SGD runs all N clients at
once: every parameter carries a leading client dimension and the layers
are batched matrix products, where the reference ``vmap``s one client's
program.  Minibatches are drawn with the reference's threefry stream
(:mod:`repro_torch.core.prng`), so the same seed picks the same samples.

Parameters keep the reference's layout (``w`` is ``(in, out)``, ``x @ w +
b``) and its flat order: ``ravel_pytree`` sorts each layer's dict keys, so
the flat vector is ``[b0, w0, b1, w1, ...]``.  The error-feedback stack,
the update stack and the aggregated delta all index that vector.

Ported: the in-memory transport and the FediAC aggregator.  Checkpointing,
probes and the packet transport raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.core import engines, prng
from repro_torch.core.baselines import make_transport
from repro_torch.core.fediac import FediACConfig
from repro_torch.switch import (SwitchProfile, client_rates, n_packets,
                                round_wall_clock)
from repro_torch.validate import (check_at_least, check_choice,
                                  check_finite_at_least, check_positive_finite)

__all__ = ["MLP", "init_mlp", "mlp_apply", "accuracy", "ravel", "unravel",
           "params_from_jax", "FLConfig", "RoundRecord", "FLHistory",
           "minibatch_indices", "make_client_round", "run_federated"]


# ---------------------------------------------------------------------------
# task model: MLP classifier
# ---------------------------------------------------------------------------

def init_mlp(key: torch.Tensor, dims: tuple[int, ...]) -> list[dict]:
    """He-normal weights, zero biases, from the reference's threefry draws
    (bitwise equal to its ``init_mlp``), on ``key``'s device."""
    ks = prng.split(key, len(dims) - 1)
    return [{"w": prng.normal(ks[i], (a, b)) * (2.0 / a) ** 0.5,
             "b": torch.zeros((b,), dtype=torch.float32, device=key.device)}
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))]


def params_from_jax(layers, device=None) -> list[dict]:
    """The reference MLP's parameters (a list of ``{"w", "b"}`` arrays, as
    numpy) as the port's, on ``device`` (the card unless told otherwise)."""
    device = resolve_device(device)
    return [{"w": torch.tensor(np.asarray(lyr["w"]), dtype=torch.float32,
                               device=device),
             "b": torch.tensor(np.asarray(lyr["b"]), dtype=torch.float32,
                               device=device)}
            for lyr in layers]


def mlp_apply(params: list[dict], x: torch.Tensor) -> torch.Tensor:
    """Logits; with a leading client dimension on every parameter and on
    ``x`` ([N, B, in]) the N models run as batched products."""
    for i, lyr in enumerate(params):
        x = torch.matmul(x, lyr["w"]) + lyr["b"].unsqueeze(-2)
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def ravel(params: list[dict]) -> torch.Tensor:
    """Flat parameter vector in ``ravel_pytree`` order ([b0, w0, b1, ...]);
    a leading client dimension is kept: ``[N, d]``."""
    lead = params[0]["b"].shape[:-1]
    return torch.cat([p.reshape(*lead, -1) for lyr in params
                      for p in (lyr["b"], lyr["w"])], dim=-1)


def unravel(flat: torch.Tensor, dims: tuple[int, ...]) -> list[dict]:
    """Inverse of :func:`ravel` (views into ``flat``)."""
    lead = flat.shape[:-1]
    out, pos = [], 0
    for a, b in zip(dims[:-1], dims[1:]):
        bias = flat[..., pos:pos + b]
        pos += b
        w = flat[..., pos:pos + a * b].reshape(*lead, a, b)
        pos += a * b
        out.append({"w": w, "b": bias})
    return out


class MLP(nn.Module):
    """The task model: ``dims[0] -> ... -> dims[-1]`` with ReLU between
    layers, parameters in the reference's layout and flat order."""

    def __init__(self, params: list[dict]):
        super().__init__()
        self.dims = (params[0]["w"].shape[0],
                     *(lyr["w"].shape[1] for lyr in params))
        self.w = nn.ParameterList([nn.Parameter(lyr["w"].clone())
                                   for lyr in params])
        self.b = nn.ParameterList([nn.Parameter(lyr["b"].clone())
                                   for lyr in params])

    def params(self) -> list[dict]:
        return [{"w": w, "b": b} for w, b in zip(self.w, self.b)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self.params(), x)

    @torch.no_grad()
    def load_flat(self, flat: torch.Tensor) -> None:
        for mine, new in zip(self.params(), unravel(flat, self.dims)):
            mine["w"].copy_(new["w"])
            mine["b"].copy_(new["b"])


def _ce_loss(params: list[dict], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the last batch axis (per client if batched)."""
    logits = mlp_apply(params, x)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.unsqueeze(-1)).squeeze(-1)
    return (logz - gold).mean(dim=-1)


@torch.no_grad()
def accuracy(model: MLP, x: torch.Tensor, y: torch.Tensor) -> float:
    pred = torch.argmax(model(x), dim=-1)
    return float((pred == y).to(torch.float32).mean())


# ---------------------------------------------------------------------------
# the FL loop
# ---------------------------------------------------------------------------

@dataclass
class FLConfig:
    """One federated-learning experiment, named as in the reference.

    Ported: ``transport="memory"`` with the FediAC aggregator.  A packet
    transport, a checkpoint path or a resume request raises; their other
    knobs come with them.
    """

    n_clients: int = 20
    rounds: int = 60
    local_steps: int = 5           # E
    batch: int = 32
    lr0: float = 0.1
    lr_tau: float = 20.0           # lr_t = lr0 / (1 + sqrt(t)/tau)   (paper V-A1)
    aggregator: str = "fediac"
    agg_kwargs: dict = field(default_factory=dict)
    engine: object | None = None    # override FediACConfig.engine
    switch: SwitchProfile = field(default_factory=SwitchProfile.high)
    local_train_s: float = 0.1     # paper: 0.1 (FEMNIST) .. 3 (CIFAR-100)
    transport: str = "memory"      # "memory" | "packet"
    seed: int = 0
    ckpt_path: str | None = None   # round-granular run-state checkpoint file
    resume: bool = False

    def __post_init__(self):
        check_at_least("n_clients", self.n_clients, 1)
        check_at_least("rounds", self.rounds, 0)
        check_at_least("local_steps", self.local_steps, 1)
        check_at_least("batch", self.batch, 1)
        check_positive_finite("lr0", self.lr0)
        check_positive_finite("lr_tau", self.lr_tau)
        check_finite_at_least("local_train_s", self.local_train_s, 0.0)
        check_choice("transport", self.transport, ("memory", "packet"))
        if self.engine is not None:
            engines.get(self.engine)   # registered name or EngineSpec


@dataclass
class RoundRecord:
    """One completed round's observations (cumulative seconds and MB)."""

    acc: float
    wall_clock: float      # cumulative seconds
    traffic_mb: float      # cumulative MB (upload + download, all clients)
    loss: float


class FLHistory:
    """Per-round :class:`RoundRecord` list with the reference's read-only
    list views (``acc``, ``wall_clock``, ``traffic_mb``, ``loss``)."""

    __slots__ = ("records",)

    def __init__(self):
        self.records: list[RoundRecord] = []

    def append_round(self, *, acc: float, wall_clock: float,
                     traffic_mb: float, loss: float) -> RoundRecord:
        rec = RoundRecord(acc, wall_clock, traffic_mb, loss)
        self.records.append(rec)
        return rec

    @property
    def acc(self) -> list:
        return [r.acc for r in self.records]

    @property
    def wall_clock(self) -> list:
        return [r.wall_clock for r in self.records]

    @property
    def traffic_mb(self) -> list:
        return [r.traffic_mb for r in self.records]

    @property
    def loss(self) -> list:
        return [r.loss for r in self.records]

    def __len__(self) -> int:
        return len(self.records)

    def __repr__(self) -> str:
        return f"FLHistory({len(self.records)} rounds)"


def _stack_clients(clients, batch: int, rng: np.random.Generator, device):
    """Pad client datasets to a common size (resampling) for the batch axis."""
    size = max(max(len(c.y) for c in clients), batch)
    xs, ys = [], []
    for c in clients:
        idx = np.arange(len(c.y))
        if len(idx) < size:
            idx = np.concatenate([idx, rng.choice(len(c.y), size - len(idx))])
        xs.append(c.x[idx])
        ys.append(c.y[idx])
    return (torch.from_numpy(np.stack(xs)).to(device),
            torch.from_numpy(np.stack(ys)).to(device))


def minibatch_indices(key: torch.Tensor, n_clients: int, local_steps: int,
                      batch: int, size: int) -> torch.Tensor:
    """int32[N, E, batch] sample indices of every client's local steps —
    the reference's ``randint`` draws under ``split(key, N)`` then
    ``split(k_i, E)``."""
    ks = prng.split(prng.split(key, n_clients), local_steps)
    return prng.randint(ks, (batch,), 0, size)


def make_client_round(dims: tuple[int, ...], batch: int, local_steps: int):
    """The per-round local-training program: E SGD steps on every client.

    ``client_round(flat, key, lr, cx, cy) -> (u_stack [N, d], losses [N])``
    with ``u = flat - w_final`` per client and ``losses`` each client's
    mean post-step loss over its E steps.
    """
    def client_round(flat, key, lr, cx, cy):
        n, size = cy.shape
        idx = minibatch_indices(key, n, local_steps, batch, size).long()
        rows = torch.arange(n, device=cx.device)[:, None]
        params = [{k: v.expand(n, *v.shape).clone().requires_grad_()
                   for k, v in lyr.items()} for lyr in unravel(flat, dims)]
        losses = []
        for s in range(local_steps):
            xb, yb = cx[rows, idx[:, s]], cy[rows, idx[:, s]]
            leaves = [p for lyr in params for p in (lyr["w"], lyr["b"])]
            grads = torch.autograd.grad(_ce_loss(params, xb, yb).sum(), leaves)
            grads = iter(grads)
            with torch.no_grad():
                params = [{k: (lyr[k] - lr * next(grads)).requires_grad_()
                           for k in ("w", "b")} for lyr in params]
                losses.append(_ce_loss(params, xb, yb))
        with torch.no_grad():
            u = flat - ravel(params)
        return u, torch.stack(losses, dim=1).mean(dim=1)

    return client_round


def run_federated(clients, test, flcfg: FLConfig, *, hidden=(128, 64),
                  device=None, probe=None) -> FLHistory:
    """Run the FL loop on ``device`` (the card unless told otherwise)."""
    if probe is not None:
        raise NotImplementedError("probes are not ported yet (ROADMAP A10)")
    if flcfg.ckpt_path or flcfg.resume:
        raise NotImplementedError("checkpointing is not ported yet "
                                  "(ROADMAP A6: checkpointing)")
    device = resolve_device(device)
    rng = np.random.default_rng(flcfg.seed)
    dim = clients[0].x.shape[1]
    n_classes = clients[0].n_classes
    dims = (dim, *hidden, n_classes)
    key = prng.PRNGKey(flcfg.seed, device=device)
    model = MLP(init_mlp(key, dims))
    flat = ravel(model.params()).detach()
    d = flat.numel()

    cx, cy = _stack_clients(clients, flcfg.batch, rng, device)
    n = cy.shape[0]
    if n != flcfg.n_clients:
        raise ValueError(f"{n} clients given, FLConfig.n_clients = "
                         f"{flcfg.n_clients}")

    agg_kwargs = dict(flcfg.agg_kwargs)
    if flcfg.aggregator == "fediac" and flcfg.engine is not None:
        base_cfg = agg_kwargs.get("cfg", FediACConfig())
        agg_kwargs["cfg"] = replace(base_cfg, engine=engines.get(flcfg.engine))
    rates = client_rates(n, flcfg.seed)
    transport = make_transport(flcfg.aggregator, transport=flcfg.transport,
                               **agg_kwargs)
    local_round = make_client_round(dims, flcfg.batch, flcfg.local_steps)

    e_stack = torch.zeros((n, d), dtype=torch.float32, device=device)
    agg_state = None
    hist = FLHistory()
    t_cum = 0.0
    mb_cum = 0.0
    xt = torch.from_numpy(test.x).to(device)
    yt = torch.from_numpy(test.y).to(device)

    for t in range(1, flcfg.rounds + 1):
        lr = flcfg.lr0 / (1.0 + np.sqrt(t) / flcfg.lr_tau)
        key, k1, k2 = prng.split(key, 3)
        u_stack, losses = local_round(flat, k1, float(lr), cx, cy)
        u_stack = u_stack + e_stack
        res = transport.round(u_stack, agg_state, k2, t)
        delta, e_stack, agg_state = res.delta, res.residuals, res.state
        traffic, load = res.traffic, res.load
        flat = flat - delta

        t_cum += round_wall_clock(
            packets_per_client=load.packets_per_client,
            download_packets=n_packets(traffic.total_bytes), rates=rates,
            profile=flcfg.switch, local_train_s=flcfg.local_train_s,
            aligned=load.aligned)
        # uploads come from the clients that sent this round; the
        # broadcast reaches all N clients.
        mb_cum += (traffic.total_bytes * res.n_active / 1e6
                   + traffic.total_bytes * n / 1e6)
        model.load_flat(flat)
        hist.append_round(acc=accuracy(model, xt, yt), wall_clock=t_cum,
                          traffic_mb=mb_cum, loss=float(losses.mean()))
    return hist
