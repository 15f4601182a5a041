"""The Byzantine-robust packet round core.

Structurally the chaos core (:mod:`repro_torch.netsim.faults`; every fault
model composes, since :class:`AdversaryConfig` extends ``FaultConfig``)
with three insertions, each a mask that is the identity when its knob sits
at its zero default:

1. **attack injection** after the round key fold: the Byzantine mask (one
   uniform per client off the *run* key, shared with the collusion draw),
   phase-2 value poisoning ``u -> poison_scale * u`` on Byzantine rows,
   and phase-1 vote stuffing (per-stuffer random chunks, or the cohort's
   shared target set for colluders);
2. **switch-side defenses** where a programmable switch can check online:
   the per-client vote budget (votes past the cap never reach the GIA
   counts) and int-domain magnitude clipping of the quantized slot
   values; the slot close is the chaos core's register-window sum when
   ``FediACConfig.robust_agg == "sum"`` and the trimmed / median
   order-statistic close (:mod:`repro_torch.core.robust_agg`) otherwise,
   under which a duplicate deposit cannot double-count;
3. the **reputation update** after the commit, threading the quarantine
   state through the core's carry, which ``PacketTransport`` returns as
   ``RoundResult.state`` and the FL loop checkpoints.

Contract: ``core(u_stack, state, key, net_key, round_idx, rates, dyn)``
returns ``(delta, residuals, aux, new_state)``, with ``dyn`` extended by
the :data:`~.adversary.ADVERSARY_DYN_FIELDS` knobs.  ``aux`` keeps every
chaos key plus the :data:`~.adversary.ROBUST_STAT_FIELDS` extras and the
``byzantine_mask``.
"""

from __future__ import annotations

import torch

from repro_torch.core import prng, xla_math
from repro_torch.core.fediac import FediACConfig, client_vote_stack
from repro_torch.core.robust_agg import trim_count, trimmed_sum
from repro_torch.netsim.batched import _gia_compress, _scatter_delta
from repro_torch.netsim.faults import _Round
from repro_torch.netsim.policies import INT32_MAX
from repro_torch.netsim.timeline import _sum_in_order

from .adversary import KEY_BYZ, KEY_STUFF, KEY_TARGET, AdversaryConfig
from .reputation import reputation_update

__all__ = ["make_robust_packet_core"]


def _z_excess(x, mask, z_thresh):
    """How far each masked client's ``x`` lies above its cohort's mean, in
    standard deviations past ``z_thresh`` (0 below it and off the mask).
    The sums run in index order from +0.0 (the reference's reduce over up
    to 32 clients) and the square root is XLA's."""
    n_m = torch.clamp_min(mask.sum(dtype=torch.int32), 1).to(torch.float32)
    x = torch.where(mask, x, 0.0)
    mu = _sum_in_order(x) / n_m
    dx = x - mu
    sigma = xla_math.sqrt(_sum_in_order(torch.where(mask, dx * dx, 0.0))
                          / n_m)
    z = dx / torch.clamp_min(sigma, 1e-6)
    return torch.where(mask, torch.clamp_min(z - z_thresh, 0.0), 0.0)


def make_robust_packet_core(cfg: FediACConfig, net: AdversaryConfig,
                            n_clients: int):
    """Build the Byzantine-robust FediAC packet round: the chaos core's
    dataplane (crash prefixes, duplicates, reset replays, quorum retry)
    with the attack injection, the defenses and the reputation state.
    ``core(u_stack, state, key, net_key, round_idx, rates, dyn)`` returns
    ``(delta, residuals, aux, new_state)`` on ``u_stack``'s device."""
    rnd = _Round(cfg, net, n_clients)
    n = rnd.n
    robust_close = cfg.robust_agg != "sum"

    def core(u_stack, state, key, net_key, round_idx, rates, dyn):
        g = rnd.open(u_stack, key, net_key, round_idx, rates)
        rk, n_chunks = g.rk, g.n_chunks
        zero = torch.zeros((), dtype=torch.int32, device=u_stack.device)

        # ---- attack injection.  One uniform per client off the run key
        # decides Byzantine membership and collusion (membership is a
        # persistent property of a client).
        u_byz = prng.uniform(prng.fold_in(net_key, KEY_BYZ), (n,))
        byz = u_byz < dyn["byzantine_frac"]
        coll = u_byz < dyn["collusion_frac"]
        # phase-2 value poisoning: the Byzantine client transmits
        # poison_scale * u
        u_eff = torch.where(byz[:, None], u_stack * dyn["poison_scale"],
                            u_stack)
        votes = client_vote_stack(u_eff, cfg, g.vote_keys).to(torch.bool)
        # phase-1 vote stuffing: independent chunks per stuffer, except
        # colluders, who all stuff the same per-round target set
        stuff_own = (prng.uniform(prng.fold_in(rk, KEY_STUFF), (n, n_chunks))
                     < dyn["vote_stuff_frac"])
        target = (prng.uniform(prng.fold_in(rk, KEY_TARGET), (n_chunks,))
                  < dyn["vote_stuff_frac"])
        stuff = torch.where(coll[:, None], target[None, :], stuff_own)
        del stuff_own
        honest_votes = votes.sum(dtype=torch.int32)
        votes = votes | (stuff & byz[:, None])
        del stuff
        n_votes = votes.sum(dtype=torch.int32)
        stuffed_votes = n_votes - honest_votes

        # ---- defense: per-client vote budget (an int counter per client;
        # 0 lifts the cap to int32 max, which the running count never
        # reaches).  The running count stays int32, as the switch's is.
        budget = torch.where(dyn["vote_budget"] > 0, dyn["vote_budget"],
                             int(INT32_MAX)).to(torch.int32)
        vote_cum = torch.cumsum(votes.to(torch.int32), dim=1,
                                dtype=torch.int32)
        votes_kept = votes & (vote_cum <= budget)
        del vote_cum
        budget_rejected = n_votes - votes_kept.sum(dtype=torch.int32)

        # ---- network phase 1 over the budgeted votes, the sampler gated
        # by the quarantine
        active = state["quarantine"].to(torch.int32) <= 0
        r = rnd.phase1(g, votes_kept, dyn, active=active)
        part, counts = r["part"], r["counts"]

        # ---- GIA + phase-2 compress over the poisoned stack (a scaled
        # update inflates everyone's f)
        f, a, plan, q_bufs, res = _gia_compress(
            cfg, rnd.spec, n, rnd.f_num_host, u_eff, r["up"], r["n_up"],
            counts, g.q_keys, dyn)
        del u_eff

        # ---- defense: int-domain magnitude clipping before the deposit
        ct = dyn["clip_ticks"]
        q_eff = torch.where(ct > 0, torch.clamp(q_bufs, -ct, ct), q_bufs)
        clipped_values = (q_eff != q_bufs).sum(dtype=torch.int32)
        del q_bufs

        start2 = rnd.start2(g, r)
        c_live = q_eff.shape[1]
        up_res = rnd.upload(g, r, start2, c_live, dyn)

        # ---- commit (all-or-nothing per client), then the slot close
        committed, n_commit = rnd.commit(r)
        if not robust_close:
            summed, n_overflow = rnd.register_close(q_eff, committed,
                                                    up_res[4], up_res[3])
            kept = n_commit
            trimmed_values = zero
        else:
            t = trim_count(cfg.robust_agg, dyn["trim_frac"], n_commit)
            summed, kept = trimmed_sum(q_eff, committed, t)
            n_overflow = zero
            trimmed_values = 2 * t * c_live
        delta = _scatter_delta(cfg, summed, plan, g.d, kept, f, n_commit)
        # error feedback: the attacker poisons the wire copy; its own state
        # keeps the honest update unshipped
        residuals = torch.where(committed[:, None] & ~byz[:, None], res,
                                u_stack)
        del res

        # ---- reputation from switch-observable signals, each centred on
        # the round's cohort
        votes_per_client = votes_kept.sum(dim=1, dtype=torch.int32)
        miss = ((votes_kept & (counts < a)[None, :]).sum(
            dim=1, dtype=torch.int32).to(torch.float32)
            / torch.clamp_min(votes_per_client, 1).to(torch.float32))
        magnitude = q_eff.abs().amax(dim=1).to(torch.float32)
        rejected = (votes & ~votes_kept).sum(dim=1, dtype=torch.int32)
        bv = (rejected.to(torch.float32)
              / torch.clamp_min(budget, 1).to(torch.float32))
        signal = (_z_excess(miss, part, dyn["rep_z_thresh"])
                  + _z_excess(magnitude, committed, dyn["rep_z_thresh"])
                  + bv)
        new_state, rep_stats = reputation_update(state, part=part,
                                                 signal=signal, dyn=dyn)

        aux = rnd.aux(g, r, committed, n_commit, up_res, start2, c_live,
                      n_overflow)
        aux.update({
            "byzantine": (byz & part).sum(dtype=torch.int32),
            "stuffed_votes": stuffed_votes,
            "budget_rejected": budget_rejected,
            "clipped_values": clipped_values,
            "trimmed_values": trimmed_values,
            "quarantined": rep_stats["quarantined"],
            "rep_flagged": rep_stats["rep_flagged"],
            "byzantine_mask": byz,
        })
        return delta, residuals, aux, new_state

    return core
