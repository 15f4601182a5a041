"""Named scenario grids: the paper's sweeps as declarative registries.

Each entry is a zero-argument factory returning a list of
:class:`ScenarioSpec`, so every figure's grid is one importable object.
The registry is the reference's (``repro.sweep.grids``), cell for cell.
"""

from __future__ import annotations

from .spec import ScenarioSpec

__all__ = ["GRIDS", "get_grid", "smoke_grid", "chaos_grid", "attack_grid",
           "algo_scenario", "BASELINE_OVERRIDES", "FEDIAC_DEFAULTS"]

# The paper Sec. V-A3 algorithm configurations.
BASELINE_OVERRIDES = {
    "switchml": (("bits", 12),),
    "libra": (("k_frac", 0.01), ("hot_frac", 0.01)),
    "omnireduce": (("k_frac", 0.05),),
    "topk": (("k_frac", 0.01),),
    "fedavg": (),
}
FEDIAC_DEFAULTS = dict(a=3, bits=12, k_frac=0.05, capacity_frac=0.05)


def algo_scenario(algo: str, **kw) -> ScenarioSpec:
    """A ScenarioSpec for one named algorithm at its paper configuration."""
    if algo == "fediac":
        return ScenarioSpec(algorithm="fediac", **FEDIAC_DEFAULTS, **kw)
    return ScenarioSpec(algorithm=algo,
                        agg_overrides=BASELINE_OVERRIDES[algo], **kw)


def smoke_grid() -> list:
    """Tiny fast grid: a FediAC vote-threshold sweep + one SwitchML
    baseline on a small task.  The three fediac cells share one batch
    signature (the threshold varies within a fleet), so the grid
    exercises two fleet groups and the per-cell threshold."""
    task = dict(n_clients=8, rounds=6, local_steps=3, batch=16,
                hidden=(32,), data_n=1500, data_dim=32, data_classes=10)
    return [
        ScenarioSpec(name="fediac-a2", algorithm="fediac", a=2, **task),
        ScenarioSpec(name="fediac-a3", algorithm="fediac", a=3, **task),
        ScenarioSpec(name="fediac-a4", algorithm="fediac", a=4, **task),
        ScenarioSpec(name="switchml", algorithm="switchml",
                     agg_overrides=BASELINE_OVERRIDES["switchml"], **task),
    ]


def fig2_grid(dist: str = "noniid") -> list:
    """Fig. 2: accuracy vs wall-clock, four algorithms x two PS profiles.
    The profile is pricing-only (outside the batch signature), so the
    high/low cells of one algorithm ride one fleet as two lanes, though
    each lane recomputes its numerics."""
    return [algo_scenario(algo, name=f"{sw}/{algo}", dist=dist,
                          switch=sw, rounds=40)
            for sw in ("high", "low")
            for algo in ("fediac", "switchml", "libra", "omnireduce")]


def fig3_grid() -> list:
    """Fig. 3: non-IID Dirichlet skew sweep, FediAC vs libra."""
    return [algo_scenario(algo, name=f"{sw}/b{beta:g}/{algo}",
                          dist="noniid", beta=beta, switch=sw, rounds=30)
            for sw in ("high", "low")
            for beta in (0.3, 0.5, 1.0, 5.0)
            for algo in ("fediac", "libra")]


def fig4_grid() -> list:
    """Fig. 4: vote threshold a (% of N) x system scale N x iid/noniid.
    Cells differing only in ``a`` share one fleet per (dist-independent)
    N."""
    return [ScenarioSpec(
                name=f"{dist}/N={n}/a={af:.0%}N", algorithm="fediac",
                a=max(1, round(af * n)), bits=12, dist=dist, switch="low",
                rounds=25, n_clients=n)
            for dist in ("iid", "noniid")
            for n in (10, 20, 30)
            for af in (0.05, 0.10, 0.15, 0.20, 0.35)]


def dataplane_grid(loss_grid=(0.0, 0.01, 0.05),
                   part_grid=(1.0, 0.5, 0.25)) -> list:
    """The packet-dataplane grid: loss x participation, one batch
    signature."""
    task = dict(algorithm="fediac", a=2, bits=12, transport="packet",
                n_clients=10, rounds=12, local_steps=3, dist="noniid",
                beta=0.5, data_n=3000, data_dim=32, test_frac=0.25)
    return [ScenarioSpec(name=f"dataplane-l{loss:g}-p{part:g}", loss=loss,
                         participation=part, **task)
            for loss in loss_grid for part in part_grid]


def chaos_grid() -> list:
    """The fault-injection grid: one clean control cell plus the fault
    families (bursty loss, crashes, duplicates, a combined storm), all
    varying only per-cell fault rates on one FaultConfig structure — the
    whole grid is a single batch signature, one fleet."""
    task = dict(algorithm="fediac", a=2, bits=12, transport="packet",
                chaos=True, dedup=True, register_policy="wrap",
                n_clients=10, rounds=10, local_steps=3, dist="noniid",
                beta=0.5, data_n=3000, data_dim=32, test_frac=0.25)
    return [
        ScenarioSpec(name="chaos-clean", **task),
        ScenarioSpec(name="chaos-ge", ge_p_gb=0.05, ge_p_bg=0.4,
                     ge_loss_bad=0.8, **task),
        ScenarioSpec(name="chaos-crash", crash_rate=0.1, crash_p2_frac=0.5,
                     **task),
        ScenarioSpec(name="chaos-dup", dup_rate=0.15, **task),
        ScenarioSpec(name="chaos-burst-crash", ge_p_gb=0.05, ge_p_bg=0.4,
                     ge_loss_bad=0.8, crash_rate=0.1, dup_rate=0.1,
                     reorder_jitter_s=0.002, **task),
    ]


def attack_grid() -> list:
    """The Byzantine grid: a clean control, each attack family
    undefended, and the defended counterparts — all varying only per-cell
    attack/defense knobs on one AdversaryConfig structure (robust_agg is
    pinned to "trim" structurally; the control and the undefended cells set
    trim_frac=0, under which the order-statistic close keeps every row and
    the aggregate is value-identical to the plain sum).  The whole grid is
    one batch signature, one fleet."""
    task = dict(algorithm="fediac", a=2, bits=12, transport="packet",
                adversary=True, robust_agg="trim",
                n_clients=10, rounds=10, local_steps=3, dist="noniid",
                beta=0.5, data_n=3000, data_dim=32, test_frac=0.25)
    attack = dict(byzantine_frac=0.25, collusion_frac=0.2,
                  vote_stuff_frac=0.3, poison_scale=-8.0)
    # vote_budget must clear the honest per-client ballot count (k =
    # ceil(0.05 * 13130) = 657 for this task, plus chaos-duplicated vote
    # packets) while still capping a stuffer's ~3900 extra ballots.
    defense = dict(vote_budget=1000, clip_ticks=1024, trim_frac=0.2,
                   rep_threshold=2.0, rep_z_thresh=2.0, quarantine_rounds=3)
    return [
        ScenarioSpec(name="attack-clean", **task),
        ScenarioSpec(name="attack-stuff", byzantine_frac=0.25,
                     collusion_frac=0.2, vote_stuff_frac=0.3, **task),
        ScenarioSpec(name="attack-poison", byzantine_frac=0.25,
                     poison_scale=-8.0, **task),
        ScenarioSpec(name="attack-full", **attack, **task),
        ScenarioSpec(name="attack-full-defended", **attack, **defense,
                     **task),
    ]


GRIDS = {
    "smoke": smoke_grid,
    "fig2": fig2_grid,
    "fig3": fig3_grid,
    "fig4": fig4_grid,
    "dataplane": dataplane_grid,
    "chaos": chaos_grid,
    "attack": attack_grid,
}


def get_grid(name: str) -> list:
    """Instantiate a named grid."""
    try:
        return GRIDS[name]()
    except KeyError:
        raise KeyError(f"unknown grid {name!r} (have {sorted(GRIDS)})") \
            from None
