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

Ported: both transports with all six aggregators of
:mod:`repro_torch.core.baselines` — the in-memory one (analytic
wall-clock) and the packet dataplane of :mod:`repro_torch.netsim`
(``transport="packet"`` with ``FLConfig.net``: simulated wall-clock and
exact upload bytes, on the plain, chaos or Byzantine-robust round core) —
FediAC on any ported engine (``FLConfig.engine``,
with bit-identical histories), round-granular checkpointing with bit-exact
resume (``ckpt_path``, ``ckpt_every``, ``resume``), the history readouts
of the paper's figures and tables, and round probes (``probe=``, a
:mod:`repro_torch.obs` probe: spans, metrics and the simulated phases of
every round, the history bit-identical with or without one).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.checkpoint import load_run_state, save_run_state
from repro_torch.core import engines, prng
from repro_torch.core.pytree import tree_map
from repro_torch.core.baselines import make_transport
from repro_torch.core.fediac import FediACConfig
from repro_torch.obs import as_probe
from repro_torch.switch import (SwitchProfile, client_rates, n_packets,
                                round_wall_clock)
from repro_torch.validate import (check_at_least, check_choice,
                                  check_finite_at_least, check_positive_finite)

__all__ = ["MLP", "init_mlp", "mlp_apply", "accuracy", "ravel", "unravel",
           "params_from_jax", "FLConfig", "RoundRecord", "FLHistory",
           "minibatch_indices", "make_client_round", "FLRun",
           "run_federated"]


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

    Any aggregator of :mod:`repro_torch.core.baselines`, through
    ``transport="memory"`` or ``"packet"`` (the dataplane, with the
    policies of ``net``: a ``netsim.NetConfig``, a ``netsim.FaultConfig``
    for the chaos core, a ``robust.AdversaryConfig`` for the
    Byzantine-robust core, whose reputation state rides the aggregator
    state, or a ``netsim.AsyncConfig`` for the quorum-or-deadline close,
    whose carry of late updates rides it the same way).  Crash-safe recovery: with ``ckpt_path`` set, the loop's
    inter-round state (model, error-feedback stack, PRNG key, aggregator
    state, pricing accumulators, history) is saved atomically every
    ``ckpt_every`` rounds and after the last; ``resume=True`` restores it
    and continues.  A run killed at round k and resumed reproduces the
    uninterrupted :class:`FLHistory` bit for bit.
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
    net: object | None = None      # NetConfig / FaultConfig /
                                   # AdversaryConfig / AsyncConfig for
                                   # transport="packet"
    seed: int = 0
    ckpt_path: str | None = None   # round-granular run-state checkpoint file
    ckpt_every: int = 1            # save every k completed rounds
    resume: bool = False           # restore ckpt_path (if present), continue

    def __post_init__(self):
        check_at_least("n_clients", self.n_clients, 1)
        check_at_least("rounds", self.rounds, 0)
        check_at_least("local_steps", self.local_steps, 1)
        check_at_least("batch", self.batch, 1)
        check_positive_finite("lr0", self.lr0)
        check_positive_finite("lr_tau", self.lr_tau)
        check_finite_at_least("local_train_s", self.local_train_s, 0.0)
        check_choice("transport", self.transport, ("memory", "packet"))
        check_at_least("ckpt_every", self.ckpt_every, 1)
        if self.engine is not None:
            engines.get(self.engine)   # registered name or EngineSpec


@dataclass
class RoundRecord:
    """One completed round's observations (cumulative seconds and MB)."""

    acc: float
    wall_clock: float      # cumulative seconds
    traffic_mb: float      # cumulative MB (upload + download, all clients)
    loss: float

    def to_metrics(self) -> dict:
        return {"acc": self.acc, "wall_clock_cum_s": self.wall_clock,
                "traffic_cum_mb": self.traffic_mb, "loss": self.loss}


class FLHistory:
    """Per-round :class:`RoundRecord` list with the reference's read-only
    list views (``acc``, ``wall_clock``, ``traffic_mb``, ``loss``)."""

    __slots__ = ("records",)

    def __init__(self, acc=(), wall_clock=(), traffic_mb=(), loss=()):
        self.records = [RoundRecord(a, w, m, l)
                        for a, w, m, l in zip(acc, wall_clock, traffic_mb,
                                              loss)]

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

    def __eq__(self, other) -> bool:
        return (isinstance(other, FLHistory)
                and self.records == other.records)

    def __repr__(self) -> str:
        return f"FLHistory({len(self.records)} rounds)"

    def acc_at_time(self, t: float) -> float:
        """The best accuracy reached within a wall-clock budget of ``t``
        seconds (the paper's Fig. 2 readout)."""
        return max([0.0] + [r.acc for r in self.records if r.wall_clock <= t])

    def traffic_to_accuracy(self, target: float) -> float | None:
        """Cumulative MB when the test accuracy first reaches ``target``
        (the paper's Tables I/II readout); None if it never does."""
        return next((r.traffic_mb for r in self.records if r.acc >= target),
                    None)


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
                      batch: int, size) -> torch.Tensor:
    """int32[N, E, batch] sample indices of every client's local steps —
    the reference's ``randint`` draws under ``split(key, N)`` then
    ``split(k_i, E)``.  ``key`` is the round's key (split into the N
    client keys here) or those client keys already split (``[N, 2]``);
    ``size`` is the sampling bound: an int, or an int32 tensor ``[N]`` of
    per-client bounds."""
    keys = key if key.dim() == 2 else prng.split(key, n_clients)
    if keys.shape[0] != n_clients:
        raise ValueError(f"{keys.shape[0]} client keys for {n_clients} "
                         "clients")
    return prng.randint(prng.split(keys, local_steps), (batch,), 0, size)


def _per_client(x, like: torch.Tensor):
    """A Python float as is; a tensor of per-client values ``[N]`` shaped
    to broadcast against ``like`` (``[N, ...]``)."""
    if not isinstance(x, torch.Tensor):
        return x
    return x.reshape(-1, *([1] * (like.dim() - 1)))


def make_client_round(dims: tuple[int, ...], batch: int, local_steps: int):
    """The per-round local-training program: E SGD steps on every client.

    ``client_round(flat, key, lr, cx, cy, size=None) -> (u_stack [N, d],
    losses [N])`` with ``u = flat - w_final`` per client and ``losses``
    each client's mean post-step loss over its E steps.  ``flat`` is the
    global model ``[d]`` or one model per client ``[N, d]``; ``key`` the
    round's key or the N client keys (:func:`minibatch_indices`); ``lr``
    a Python float or a float32 tensor ``[N]`` of per-client rates;
    ``size`` the sampling bound: ``None`` (all of ``cy``'s rows), an int,
    or an int32 tensor ``[N]``, so a client whose rows were zero-padded
    past its own draws from its own.  Each client's bits do not depend on
    which other clients share the call, up to the batched products of the
    device (``repro_torch.sweep.fleet`` says where they hold).
    """
    def client_round(flat, key, lr, cx, cy, size=None):
        n = cy.shape[0]
        size = cy.shape[1] if size is None else size
        idx = minibatch_indices(key, n, local_steps, batch, size).long()
        rows = torch.arange(n, device=cx.device)[:, None]
        models = unravel(flat, dims)
        if flat.dim() == 1:
            models = [{k: v.expand(n, *v.shape) for k, v in lyr.items()}
                      for lyr in models]
        params = [{k: v.clone().requires_grad_() for k, v in lyr.items()}
                  for lyr in models]
        losses = []
        for s in range(local_steps):
            xb, yb = cx[rows, idx[:, s]], cy[rows, idx[:, s]]
            leaves = [p for lyr in params for p in (lyr["w"], lyr["b"])]
            grads = torch.autograd.grad(_ce_loss(params, xb, yb).sum(), leaves)
            grads = iter(grads)
            with torch.no_grad():
                params = [{k: (lyr[k] - _per_client(lr, lyr[k])
                               * next(grads)).requires_grad_()
                           for k in ("w", "b")} for lyr in params]
                losses.append(_ce_loss(params, xb, yb))
        with torch.no_grad():
            u = flat - ravel(params)
        return u, torch.stack(losses, dim=1).mean(dim=1)

    return client_round


def _carry_in(u_stack: torch.Tensor, e_stack: torch.Tensor) -> torch.Tensor:
    """Fold the error-feedback carry into the fresh update stack."""
    return u_stack + e_stack


class FLRun:
    """One FL run between its rounds: the data, the model, the
    error-feedback stack, the PRNG key, the round transport, the
    aggregator state, the pricing accumulators and the history.

    :func:`run_federated` drives one; the sweep's fleet
    (:mod:`repro_torch.sweep.fleet`) drives several, with their local
    training in one batched call, through the same methods, so the two
    give the same bits.  A round is :meth:`next_keys`, local training
    (``make_client_round`` at :meth:`lr`), :func:`_carry_in` with
    ``e_stack``, ``transport.round``, :meth:`apply`, :meth:`evaluate` and
    :meth:`record`.
    """

    def __init__(self, clients, test, flcfg: FLConfig, *, hidden, device,
                 wrap_transport=None):
        self.cfg = flcfg
        rng = np.random.default_rng(flcfg.seed)
        dim = clients[0].x.shape[1]
        n_classes = clients[0].n_classes
        self.dims = (dim, *hidden, n_classes)
        self.key = prng.PRNGKey(flcfg.seed, device=device)
        self.model = MLP(init_mlp(self.key, self.dims))
        self.flat = ravel(self.model.params()).detach()
        d = self.flat.numel()

        self.cx, self.cy = _stack_clients(clients, flcfg.batch, rng, device)
        n = self.n = self.cy.shape[0]
        if n != flcfg.n_clients:
            raise ValueError(f"{n} clients given, FLConfig.n_clients = "
                             f"{flcfg.n_clients}")

        agg_kwargs = dict(flcfg.agg_kwargs)
        if flcfg.aggregator == "fediac" and flcfg.engine is not None:
            base_cfg = agg_kwargs.get("cfg", FediACConfig())
            agg_kwargs["cfg"] = replace(base_cfg,
                                        engine=engines.get(flcfg.engine))
        self.rates = client_rates(n, flcfg.seed)
        transport = make_transport(flcfg.aggregator,
                                   transport=flcfg.transport, net=flcfg.net,
                                   profile=flcfg.switch, rates=self.rates,
                                   local_train_s=flcfg.local_train_s,
                                   **agg_kwargs)
        if wrap_transport is not None:
            transport = wrap_transport(transport)
        self.transport = transport

        self.e_stack = torch.zeros((n, d), dtype=torch.float32, device=device)
        self.agg_state = None
        self.hist = FLHistory()
        self.t_cum = 0.0
        self.mb_cum = 0.0
        self.start_round = 0
        if flcfg.resume and flcfg.ckpt_path and os.path.exists(flcfg.ckpt_path):
            # the state saved after the last completed round; everything
            # built above (data, rates, transport) is a pure function of
            # the config
            st = load_run_state(flcfg.ckpt_path)
            self.flat = torch.from_numpy(st["flat"]).to(device)
            self.e_stack = torch.from_numpy(st["e_stack"]).to(device)
            self.key = torch.from_numpy(st["key"].astype(np.int64)).to(device)
            self.agg_state = tree_map(lambda a: torch.from_numpy(a).to(device),
                                      st["agg_state"])
            self.start_round = st["round"]
            self.t_cum, self.mb_cum = st["t_cum"], st["mb_cum"]
            self.hist = FLHistory(**st["history"])
        self.xt = torch.from_numpy(test.x).to(device)
        self.yt = torch.from_numpy(test.y).to(device)

    def lr(self, t: int) -> float:
        """Round ``t``'s learning rate, ``lr0 / (1 + sqrt(t) / tau)``."""
        return float(self.cfg.lr0 / (1.0 + np.sqrt(t) / self.cfg.lr_tau))

    def next_keys(self):
        """Advance the run's key; the round's (local-training, aggregator)
        keys."""
        self.key, k1, k2 = prng.split(self.key, 3)
        return k1, k2

    def apply(self, res) -> tuple[float, float]:
        """Take the round's aggregate and price the round: the simulated
        clock and the traffic, in the reference's accumulation order.
        Returns the clock before the round and the upload bytes."""
        self.flat = self.flat - res.delta
        self.e_stack, self.agg_state = res.residuals, res.state
        traffic, load = res.traffic, res.load
        sim_t0 = self.t_cum
        if res.wall_clock_s is not None:
            self.t_cum += res.wall_clock_s       # packet-simulated round time
        else:
            self.t_cum += round_wall_clock(
                packets_per_client=load.packets_per_client,
                download_packets=n_packets(traffic.total_bytes),
                rates=self.rates, profile=self.cfg.switch,
                local_train_s=self.cfg.local_train_s, aligned=load.aligned)
        # uploads come from the clients that sent this round (the packet
        # transport reports exact bytes: dropped voters still spent phase
        # 1); the broadcast reaches all N clients.
        up_bytes = (res.upload_bytes if res.upload_bytes is not None
                    else traffic.total_bytes * res.n_active)
        self.mb_cum += up_bytes / 1e6 + traffic.total_bytes * self.n / 1e6
        return sim_t0, up_bytes

    def logits(self) -> torch.Tensor:
        """The current model's test logits."""
        self.model.load_flat(self.flat)
        with torch.no_grad():
            return self.model(self.xt)

    def evaluate(self) -> float:
        """The current model's test accuracy."""
        self.model.load_flat(self.flat)
        return accuracy(self.model, self.xt, self.yt)

    def record(self, acc: float, losses: torch.Tensor) -> RoundRecord:
        return self.hist.append_round(acc=acc, wall_clock=self.t_cum,
                                      traffic_mb=self.mb_cum,
                                      loss=float(losses.mean()))

    def save(self, t: int) -> None:
        save_run_state(self.cfg.ckpt_path, flat=self.flat,
                       e_stack=self.e_stack, key=self.key,
                       agg_state=self.agg_state, round_idx=t,
                       t_cum=self.t_cum, mb_cum=self.mb_cum, history=self.hist)


def run_federated(clients, test, flcfg: FLConfig, *, hidden=(128, 64),
                  device=None, probe=None, wrap_transport=None) -> FLHistory:
    """Run the FL loop on ``device`` (the card unless told otherwise).

    ``probe`` is an optional :mod:`repro_torch.obs` probe.  It observes
    only host-side values the loop already computes (plus the transport's
    stats dict), so with any probe, the default ``NullProbe`` included,
    the history is bit-identical to the run without one.

    ``wrap_transport``, if given, is applied to the round transport the
    loop builds from ``flcfg``, and the loop uses what it returns: an
    object whose ``round(u_stack, state, key, t)`` gives the round's
    result.  It lets a caller watch each round's aggregation, or run it
    on inputs of its own."""
    probe = as_probe(probe)
    run = FLRun(clients, test, flcfg, hidden=hidden,
                device=resolve_device(device), wrap_transport=wrap_transport)
    local_round = make_client_round(run.dims, flcfg.batch, flcfg.local_steps)
    # host-side observation only: wrap_jit counts calls and times them
    # around the same callables (NullProbe returns them unchanged), and
    # transports with probe support wrap their round cores
    local_round = probe.wrap_jit(local_round, "local_round")
    carry_in = probe.wrap_jit(_carry_in, "carry_in")
    attach = getattr(run.transport, "attach_probe", None)
    if attach is not None:
        attach(probe)

    if probe.enabled:
        probe.run_start(kind="fl_run", aggregator=flcfg.aggregator,
                        transport=flcfg.transport,
                        engine=(engines.get(flcfg.engine).name
                                if flcfg.engine is not None else None),
                        n_clients=run.n, rounds=flcfg.rounds, seed=flcfg.seed,
                        resumed_from=run.start_round or None)

    for t in range(run.start_round + 1, flcfg.rounds + 1):
        with probe.span("round", round=t):
            lr = run.lr(t)
            k1, k2 = run.next_keys()
            with probe.span("local-train", round=t):
                u_stack, losses = local_round(run.flat, k1, lr, run.cx,
                                              run.cy)
                u_stack = carry_in(u_stack, run.e_stack)
            with probe.span("aggregate", round=t):
                res = run.transport.round(u_stack, run.agg_state, k2, t)
            sim_t0, up_bytes = run.apply(res)
            with probe.span("eval", round=t):
                acc_t = run.evaluate()
            rec = run.record(acc_t, losses)
            if probe.enabled:
                _emit_round(probe, t, rec, res, sim_t0, run.t_cum, up_bytes,
                            res.traffic.total_bytes * run.n)
            if flcfg.ckpt_path and (t % flcfg.ckpt_every == 0
                                    or t == flcfg.rounds):
                with probe.span("ckpt", round=t):
                    run.save(t)
    return run.hist


def _emit_round(probe, t: int, rec: RoundRecord, res, sim_t0: float,
                sim_t1: float, up_bytes: float, bcast_bytes: float) -> None:
    """Feed one completed round to an enabled probe.

    Only called when ``probe.enabled``: everything here reads values the
    round already produced (RoundRecord, RoundResult stats), so disabled
    runs skip even the dict construction.
    """
    payload = dict(res.to_metrics())
    payload.update(acc=rec.acc, loss=rec.loss, upload_bytes=up_bytes,
                   broadcast_bytes=bcast_bytes,
                   wall_clock_s=sim_t1 - sim_t0)
    probe.metrics(payload, round=t)
    # the simulated round timeline: phase 1 (voting) then phase 2
    # (aggregation), on the cumulative sim clock
    st = res.stats or {}
    p1, p2 = st.get("phase1_s"), st.get("phase2_s")
    if p1 is not None:
        probe.sim_phase("phase1-vote", sim_t0, sim_t0 + float(p1), round=t)
        if p2 is not None:
            probe.sim_phase("phase2-aggregate", sim_t0 + float(p1),
                            sim_t0 + float(p1) + float(p2), round=t)
    else:
        probe.sim_phase("sim-round", sim_t0, sim_t1, round=t)
