"""The paper's objective (Eq. 1): alpha * sum_j E_j + (1 - alpha) * AvgTPE.

EaCO's greedy loop realizes this objective through its pack-hottest-first
heuristic; this module evaluates the cost explicitly so that (a) decisions
can be logged/audited against the objective, and (b) the beyond-paper
``EaCO-occ`` variant can rank candidates by estimated cost delta instead of
raw utilization.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from repro_torch.cluster import colocation
from repro_torch.cluster.job import Job
from repro_torch.cluster.power import PowerModel


def allocation_cost(
    jobs: Sequence[Job],
    inflation: float,
    power: PowerModel,
    alpha: float = 0.5,
    norm_energy_kwh: float = 100.0,
    norm_tpe_h: float = 1.0,
) -> float:
    """Cost of running ``jobs`` co-located on one node to completion.

    E_j split: node energy attributed by compute share; AvgTPE = mean
    inflated epoch time.  Both terms normalized so alpha weights
    comparable magnitudes (the paper leaves normalization implicit).
    """
    if not jobs:
        return 0.0
    profiles = [j.profile for j in jobs]
    util = colocation.combined_gpu_util(profiles)
    p_node = power.node_power(util)
    # serialized-on-one-node runtime: the longest co-located completion
    hours = max(j.remaining_epochs * j.profile.epoch_hours * inflation for j in jobs)
    energy = p_node * hours / 1000.0
    avg_tpe = sum(p.epoch_hours * inflation for p in profiles) / len(profiles)
    return alpha * energy / norm_energy_kwh + (1 - alpha) * avg_tpe / norm_tpe_h


def marginal_cost(
    newcomer: Job,
    residents: Sequence[Job],
    inflation_with: float,
    power: PowerModel,
    alpha: float = 0.5,
) -> float:
    """Cost delta of adding ``newcomer`` to ``residents`` vs a fresh node."""
    with_cost = allocation_cost([newcomer, *residents], inflation_with, power, alpha)
    without = allocation_cost(list(residents), 1.0 if len(residents) <= 1 else inflation_with, power, alpha)
    fresh = allocation_cost([newcomer], 1.0, power, alpha)
    return with_cost - without - fresh  # negative == co-location wins
