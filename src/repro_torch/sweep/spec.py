"""Declarative FL scenarios: one frozen spec per sweep cell.

A :class:`ScenarioSpec` names everything the paper sweeps over — algorithm,
vote threshold, compaction mode, non-IID skew, participation, loss,
transport, hierarchy depth — plus the task geometry (clients, rounds, model
width, data size).  Specs are frozen and hashable so the runner can cache
data builds and group cells.  The fields, defaults, validation, labels,
batch signatures and cell keys are the reference's (``repro.sweep.spec``),
so a grid groups and keys the same cells in both packages.

:meth:`ScenarioSpec.batch_signature` splits the fields in two: those that
fix a fleet's shapes and structure (algorithm, model and data geometry,
static compression config, the structural network knobs) form the
signature; the rest — the vote threshold ``a``, the learning-rate
schedule, the data itself (seed, skew, distribution), the pricing and the
network, fault, async and attack rates — differ from cell to cell within
one fleet (:mod:`repro_torch.sweep.fleet`).
"""

from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass, replace

from repro_torch.core.fediac import FediACConfig
from repro_torch.data import (classification, partition_dirichlet,
                              partition_iid)
from repro_torch.validate import (check_at_least, check_choice,
                                  check_finite_at_least, check_interval,
                                  check_positive_finite)

__all__ = ["ScenarioSpec", "make_task", "cell_key"]

# Fields that vary from cell to cell within one fleet (outside the batch
# signature), by what they change.  Every other field is structural: the
# fleet's shapes, the aggregator and its static config, and the structural
# network knobs (chaos, dedup, register_policy, quorum_floor,
# round_retries, consensus_floor; async_agg, staleness_mode, late_policy,
# round_deadline_s; adversary, robust_agg).
_FEDIAC_DYNAMIC = ("a", "a_frac")       # the vote threshold
_PRICING_ONLY = ("switch", "local_train_s")  # the round's pricing
_DATA_ONLY = ("name", "dist", "beta")   # the data, not the shapes
_NET_DYNAMIC = ("loss", "participation", "straggler_frac", "net_seed")
                                        # a packet cell's network draws
_FAULT_DYNAMIC = ("ge_p_gb", "ge_p_bg", "ge_loss_bad", "crash_rate",
                  "crash_p2_frac", "dup_rate", "reorder_jitter_s",
                  "reg_reset_rate", "backoff_s")
                                        # a chaos cell's fault rates
_ASYNC_DYNAMIC = ("quorum_frac", "staleness_weight", "staleness_gamma",
                  "staleness_cap")
                                        # an async cell's close knobs
_ADVERSARY_DYNAMIC = ("byzantine_frac", "collusion_frac", "vote_stuff_frac",
                      "poison_scale", "vote_budget", "clip_ticks",
                      "trim_frac", "rep_decay", "rep_threshold",
                      "rep_z_thresh", "quarantine_rounds")
                                        # a robust cell's attack and
                                        # defense knobs


@dataclass(frozen=True)
class ScenarioSpec:
    """One federated-learning scenario (a sweep grid cell, minus the seed)."""

    name: str = ""
    algorithm: str = "fediac"      # baselines registry name
    # --- FediAC compression knobs (ignored for baselines)
    a: int | None = None           # vote threshold; None -> ceil(a_frac * N)
    a_frac: float = 0.15
    bits: int = 12
    k_frac: float = 0.05
    capacity_frac: float = 0.05
    vote_mode: str = "topk"        # topk | threshold
    compact_mode: str = "topk"     # topk | block
    engine: object = "monolithic"  # registered engine name (monolithic |
                                   # stream | sharded) or an EngineSpec —
                                   # all bit-identical
    # --- baseline aggregator kwargs, as a hashable (key, value) tuple
    agg_overrides: tuple = ()
    # --- task geometry
    n_clients: int = 20
    rounds: int = 40
    local_steps: int = 5
    batch: int = 32
    lr0: float = 0.1
    lr_tau: float = 20.0
    hidden: tuple = (128, 64)
    # --- data
    dist: str = "noniid"           # iid | noniid (Dirichlet)
    beta: float = 0.5              # Dirichlet skew (noniid only)
    data_n: int = 8000
    data_dim: int = 48
    data_classes: int = 10
    test_frac: float = 0.2
    # --- round pricing (analytic wall-clock; never enters the numerics)
    switch: str = "high"           # high | low SwitchProfile
    local_train_s: float = 0.1
    # --- network (packet transport)
    transport: str = "memory"      # memory | packet
    loss: float = 0.0
    participation: float = 1.0
    straggler_frac: float = 0.0
    n_leaves: int = 1              # switch hierarchy depth (1 = single PS)
    net_seed: int = 0
    # --- chaos dataplane (packet transport only).  chaos=True builds a
    # FaultConfig (fault-injected round core); the rate fields vary within
    # a fleet, the policy fields are structural.
    chaos: bool = False
    ge_p_gb: float = 0.0
    ge_p_bg: float = 0.5
    ge_loss_bad: float = 1.0
    crash_rate: float = 0.0
    crash_p2_frac: float = 0.5
    dup_rate: float = 0.0
    dedup: bool = True
    reorder_jitter_s: float = 0.0
    register_policy: str = "wrap"
    reg_reset_rate: float = 0.0
    quorum_floor: int = 0
    round_retries: int = 2
    backoff_s: float = 0.1
    consensus_floor: int = 0       # FediACConfig dense-mask fallback floor
    # --- async quorum-or-deadline close (packet transport only).
    # async_agg=True builds an AsyncConfig round core; the scalar close
    # knobs vary within a fleet, the mode/policy fields are structural.
    async_agg: bool = False
    quorum_frac: float = 1.0
    round_deadline_s: float | None = None
    staleness_mode: str = "constant"
    staleness_weight: float = 1.0
    staleness_gamma: float = 1.0
    staleness_cap: float = 4.0
    late_policy: str = "fold"
    # --- Byzantine adversary + switch-side defenses (packet transport
    # only).  adversary=True builds an AdversaryConfig round core (which
    # extends FaultConfig, so the chaos knobs above compose); the scalar
    # attack/defense knobs vary within a fleet, robust_agg is structural.
    adversary: bool = False
    byzantine_frac: float = 0.0
    collusion_frac: float = 0.0
    vote_stuff_frac: float = 0.0
    poison_scale: float = 1.0
    vote_budget: int = 0
    clip_ticks: int = 0
    robust_agg: str = "sum"        # sum | trim | median (slot close)
    trim_frac: float = 0.0
    rep_decay: float = 0.9
    rep_threshold: float = float("inf")
    rep_z_thresh: float = 3.0
    quarantine_rounds: int = 0

    def __post_init__(self):
        check_interval("k_frac", self.k_frac, 0.0, 1.0, lo_open=True)
        check_interval("capacity_frac", self.capacity_frac, 0.0, 1.0,
                       lo_open=True)
        check_interval("a_frac", self.a_frac, 0.0, 1.0, lo_open=True)
        if self.a is not None:
            check_at_least("a", self.a, 1)
        check_at_least("bits", self.bits, 1)
        check_choice("vote_mode", self.vote_mode, ("topk", "threshold"))
        check_choice("compact_mode", self.compact_mode, ("topk", "block"))
        for name in ("n_clients", "rounds", "local_steps", "batch",
                     "data_n", "data_dim", "data_classes", "n_leaves"):
            check_at_least(name, getattr(self, name), 1)
        check_positive_finite("lr0", self.lr0)
        check_positive_finite("lr_tau", self.lr_tau)
        check_positive_finite("beta", self.beta)
        check_interval("test_frac", self.test_frac, 0.0, 1.0, lo_open=True,
                       hi_open=True)
        check_choice("dist", self.dist, ("iid", "noniid"))
        check_choice("switch", self.switch, ("high", "low"))
        check_finite_at_least("local_train_s", self.local_train_s, 0.0)
        check_choice("transport", self.transport, ("memory", "packet"))
        check_interval("loss", self.loss, 0.0, 1.0, hi_open=True)
        check_interval("participation", self.participation, 0.0, 1.0,
                       lo_open=True)
        check_interval("straggler_frac", self.straggler_frac, 0.0, 1.0)
        for name in ("ge_p_gb", "ge_p_bg", "ge_loss_bad", "crash_rate",
                     "crash_p2_frac", "dup_rate", "reg_reset_rate"):
            check_interval(name, getattr(self, name), 0.0, 1.0)
        check_finite_at_least("reorder_jitter_s", self.reorder_jitter_s, 0.0)
        check_finite_at_least("backoff_s", self.backoff_s, 0.0)
        check_at_least("quorum_floor", self.quorum_floor, 0)
        check_at_least("round_retries", self.round_retries, 0)
        check_at_least("consensus_floor", self.consensus_floor, 0)
        if self.async_agg and self.chaos:
            raise ValueError("async_agg and chaos are mutually exclusive "
                             "(one round core per cell)")
        if self.async_agg and self.adversary:
            raise ValueError("async_agg and adversary are mutually exclusive "
                             "(one round core per cell)")
        check_interval("byzantine_frac", self.byzantine_frac, 0.0, 1.0,
                       hi_open=True)
        check_interval("collusion_frac", self.collusion_frac, 0.0, 1.0,
                       hi_open=True)
        if self.collusion_frac > self.byzantine_frac:
            raise ValueError(
                f"collusion_frac must be <= byzantine_frac (the colluding "
                f"cohort is a subset of the Byzantine set), got "
                f"{self.collusion_frac}")
        check_interval("vote_stuff_frac", self.vote_stuff_frac, 0.0, 1.0)
        import math as _math
        if not _math.isfinite(self.poison_scale):
            raise ValueError(f"poison_scale must be finite, got "
                             f"{self.poison_scale}")
        check_at_least("vote_budget", self.vote_budget, 0)
        check_at_least("clip_ticks", self.clip_ticks, 0)
        check_choice("robust_agg", self.robust_agg, ("sum", "trim", "median"))
        check_interval("trim_frac", self.trim_frac, 0.0, 0.5, hi_open=True)
        check_interval("rep_decay", self.rep_decay, 0.0, 1.0)
        if not self.rep_threshold > 0.0:
            raise ValueError(f"rep_threshold must be > 0 (+inf disables "
                             f"quarantine), got {self.rep_threshold}")
        check_finite_at_least("rep_z_thresh", self.rep_z_thresh, 0.0)
        check_at_least("quarantine_rounds", self.quarantine_rounds, 0)
        check_choice("staleness_mode", self.staleness_mode,
                     ("constant", "poly", "cap"))
        check_choice("late_policy", self.late_policy, ("fold", "bounce"))
        check_interval("quorum_frac", self.quorum_frac, 0.0, 1.0,
                       lo_open=True)
        if self.round_deadline_s is not None:
            check_positive_finite("round_deadline_s", self.round_deadline_s)
        check_interval("staleness_weight", self.staleness_weight, 0.0, 1.0,
                       lo_open=True)
        check_finite_at_least("staleness_gamma", self.staleness_gamma, 0.0)
        check_finite_at_least("staleness_cap", self.staleness_cap, 0.0)
        from repro_torch.core import engines
        engines.get(self.engine)   # registered name or EngineSpec

    # ------------------------------------------------------------------
    def fediac_config(self) -> FediACConfig:
        return FediACConfig(a=self.a, a_frac=self.a_frac, bits=self.bits,
                            k_frac=self.k_frac,
                            capacity_frac=self.capacity_frac,
                            vote_mode=self.vote_mode,
                            compact_mode=self.compact_mode,
                            engine=self.engine,
                            consensus_floor=self.consensus_floor,
                            robust_agg=self.robust_agg,
                            trim_frac=self.trim_frac)

    def agg_kwargs(self) -> dict:
        """Aggregator kwargs for ``make_aggregator`` / ``make_transport``."""
        if self.algorithm == "fediac":
            return {"cfg": self.fediac_config(), **dict(self.agg_overrides)}
        return dict(self.agg_overrides)

    def core_kwargs(self) -> dict:
        """Aggregator kwargs for the (core, account) pair with the
        per-cell knobs normalized away: for FediAC the vote threshold is
        carried by :meth:`dyn_scalars` instead of the config, so cells
        differing only in ``a``/``a_frac`` bind the same core."""
        if self.algorithm == "fediac":
            # trim_frac is normalized away like a: the robust packet core
            # reads it from dyn.
            cfg = replace(self.fediac_config(), a=None,
                          a_frac=type(self).a_frac,
                          trim_frac=type(self).trim_frac)
            return {"cfg": cfg, **dict(self.agg_overrides)}
        return dict(self.agg_overrides)

    def dyn_scalars(self) -> dict:
        """The per-cell scalars of the round core (the vote threshold)."""
        if self.algorithm == "fediac":
            return {"a": self.fediac_config().threshold(self.n_clients)}
        return {}

    def net_config(self):
        """The :class:`repro_torch.netsim.NetConfig` of a packet cell — a
        :class:`repro_torch.netsim.FaultConfig` when ``chaos`` is set, an
        :class:`repro_torch.netsim.AsyncConfig` when ``async_agg`` is set,
        a :class:`repro_torch.robust.AdversaryConfig` when ``adversary`` is
        set (subsuming the chaos knobs — the fault fields compose)."""
        from repro_torch.netsim import AsyncConfig, FaultConfig, NetConfig
        base = dict(loss=self.loss, participation=self.participation,
                    straggler_frac=self.straggler_frac,
                    n_leaves=self.n_leaves, seed=self.net_seed)
        if self.adversary:
            from repro_torch.robust import AdversaryConfig
            return AdversaryConfig(
                ge_p_gb=self.ge_p_gb, ge_p_bg=self.ge_p_bg,
                ge_loss_bad=self.ge_loss_bad, crash_rate=self.crash_rate,
                crash_p2_frac=self.crash_p2_frac, dup_rate=self.dup_rate,
                dedup=self.dedup, reorder_jitter_s=self.reorder_jitter_s,
                register_policy=self.register_policy,
                reg_reset_rate=self.reg_reset_rate,
                quorum_floor=self.quorum_floor,
                round_retries=self.round_retries, backoff_s=self.backoff_s,
                byzantine_frac=self.byzantine_frac,
                collusion_frac=self.collusion_frac,
                vote_stuff_frac=self.vote_stuff_frac,
                poison_scale=self.poison_scale,
                vote_budget=self.vote_budget, clip_ticks=self.clip_ticks,
                rep_decay=self.rep_decay, rep_threshold=self.rep_threshold,
                rep_z_thresh=self.rep_z_thresh,
                quarantine_rounds=self.quarantine_rounds, **base)
        if self.async_agg:
            return AsyncConfig(quorum_frac=self.quorum_frac,
                               round_deadline_s=self.round_deadline_s,
                               staleness_mode=self.staleness_mode,
                               staleness_weight=self.staleness_weight,
                               staleness_gamma=self.staleness_gamma,
                               staleness_cap=self.staleness_cap,
                               late_policy=self.late_policy,
                               register_policy=self.register_policy,
                               **base)
        if not self.chaos:
            return NetConfig(**base)
        return FaultConfig(ge_p_gb=self.ge_p_gb, ge_p_bg=self.ge_p_bg,
                           ge_loss_bad=self.ge_loss_bad,
                           crash_rate=self.crash_rate,
                           crash_p2_frac=self.crash_p2_frac,
                           dup_rate=self.dup_rate, dedup=self.dedup,
                           reorder_jitter_s=self.reorder_jitter_s,
                           register_policy=self.register_policy,
                           reg_reset_rate=self.reg_reset_rate,
                           quorum_floor=self.quorum_floor,
                           round_retries=self.round_retries,
                           backoff_s=self.backoff_s, **base)

    # ------------------------------------------------------------------
    def to_flconfig(self, seed: int):
        """The :class:`repro_torch.training.fl_loop.FLConfig` of one cell."""
        from repro_torch.training.fl_loop import FLConfig
        from repro_torch.switch import SwitchProfile
        net = self.net_config() if self.transport == "packet" else None
        profile = (SwitchProfile.high() if self.switch == "high"
                   else SwitchProfile.low())
        return FLConfig(n_clients=self.n_clients, rounds=self.rounds,
                        local_steps=self.local_steps, batch=self.batch,
                        lr0=self.lr0, lr_tau=self.lr_tau,
                        aggregator=self.algorithm,
                        agg_kwargs=self.agg_kwargs(), switch=profile,
                        local_train_s=self.local_train_s,
                        transport=self.transport, net=net, seed=seed)

    def make_task(self, seed: int):
        """(clients, test) for one cell — cached across cells that share
        the data configuration."""
        return make_task(self.data_n, self.data_dim, self.data_classes,
                         self.test_frac, self.dist, self.beta,
                         self.n_clients, seed)

    # ------------------------------------------------------------------
    def batchable(self) -> bool:
        """Can this scenario ride a fleet (:mod:`repro_torch.sweep.fleet`)?

        The reference's rule, kept so both packages group a grid alike:
        memory-transport cells batch for every registered aggregator core;
        packet-transport cells batch for FediAC on the monolithic and
        sharded engines.  Packet baselines and packet cells on the stream
        engine take the sequential path."""
        from repro_torch.core.baselines import _CORES
        if self.transport == "packet":
            return (self.algorithm == "fediac"
                    and self.engine_name() in ("monolithic", "sharded"))
        return self.transport == "memory" and self.algorithm in _CORES

    def engine_name(self) -> str:
        """The resolved engine-registry name of ``self.engine``."""
        from repro_torch.core import engines
        return engines.get(self.engine).name

    def batch_signature(self) -> tuple:
        """Hashable key of everything that fixes a fleet's shapes and
        structure.

        Cells with equal signatures run as one fleet; the excluded fields
        vary within it (vote threshold, lr schedule, data; for packet
        cells also the network, fault, async and attack knobs, the net
        seed, the switch service time and the local train time) or only
        price the round (switch profile, local train time).
        """
        excluded = (_FEDIAC_DYNAMIC + _PRICING_ONLY + _DATA_ONLY
                    + _NET_DYNAMIC + _FAULT_DYNAMIC + _ASYNC_DYNAMIC
                    + _ADVERSARY_DYNAMIC + ("lr0", "lr_tau"))
        items = tuple(sorted((k, v) for k, v in self.__dict__.items()
                             if k not in excluded))
        return (self.algorithm,) + items

    def label(self) -> str:
        """Short human-readable cell label."""
        if self.name:
            return self.name
        bits = [self.algorithm]
        if self.algorithm == "fediac":
            bits.append(f"a{self.a}" if self.a is not None
                        else f"af{self.a_frac:g}")
        bits.append(f"{self.dist}{self.beta:g}" if self.dist == "noniid"
                    else "iid")
        if self.transport == "packet":
            bits.append(f"loss{self.loss:g}-part{self.participation:g}")
        return "-".join(bits)


def cell_key(spec: ScenarioSpec, seed: int) -> str:
    """Stable progress-file key for one (scenario, seed) cell.  No '/' —
    the checkpoint format uses it as a path separator."""
    h = hashlib.sha1(repr((sorted(spec.__dict__.items()), seed))
                     .encode()).hexdigest()[:10]
    return f"{spec.label()}.s{seed}.{h}".replace("/", "_")


@functools.lru_cache(maxsize=32)
def make_task(data_n: int, data_dim: int, data_classes: int, test_frac: float,
              dist: str, beta: float, n_clients: int, seed: int):
    """Build (clients, test) for one cell.  Identical parameters (shared
    across scenarios that differ only in algorithm/threshold) hit the cache."""
    data = classification(n=data_n, dim=data_dim, n_classes=data_classes,
                          seed=seed)
    train, test = data.test_split(test_frac)
    if dist == "iid":
        clients = partition_iid(train, n_clients, seed)
    else:
        clients = partition_dirichlet(train, n_clients, beta=beta, seed=seed)
    return tuple(clients), test
