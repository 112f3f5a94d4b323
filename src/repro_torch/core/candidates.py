"""FindCandidates (EaCO Algorithm 2).

Enumerates GPU sets that can host job ``j``:
  * every GPU in the set below the core-utilization threshold (Eq. 3),
  * every GPU below the memory threshold (Eq. 4),
  * accumulated available memory (1 - peak usage of residents) covers j's
    estimated demand,
  * GPU count matches the request, all on one node (the paper scopes EaCO
    to intra-node sharing).

Full subset enumeration over 8 GPUs is exponential; per node we emit the
canonical candidates that the greedy outer loop would ever pick: the k
hottest eligible GPUs (EaCO packs hottest-first) and, as fallback, the k
coldest (fresh nodes).  For whole-node jobs (the paper's experiments) both
collapse to "the node".

Two implementations produce that list:

  * ``find_candidates_reference`` — the original O(fleet x gpus) scan,
    kept verbatim for free-standing simulators without a ``FleetState``
    and as the oracle for the differential tests;
  * the columnar fast path — reads the fleet index sets: idle nodes come
    from the per-(SKU, gpu-count) idle-class structure (with
    ``dedup_idle`` only the lowest-id representative per class, which is
    provably the member the full enumeration would place on), busy nodes
    from the sorted busy set with a cached eligible-GPU prefilter.  Every
    float op matches the reference expression, so outputs are
    bit-identical (``tests/test_fleet_vectorized.py`` locks this).

``dedup_idle`` is only byte-safe for rankers that cannot distinguish two
idle nodes of the same class (EaCO's and its subclasses' sort keys —
utilization, perf/watt, degree — are all class-determined).  Schedulers
whose choice depends on list *positions* must keep it off:
``EaCOPowerCap`` budgets its joint frequency search by candidate index.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from repro_torch.cluster import dvfs
from repro_torch.cluster.colocation import HOST_OVERSUB_LIMIT, HOST_SUPPLY
from repro_torch.cluster.job import Job
from repro_torch.cluster.node import Node, NodeState


class Candidate(NamedTuple):
    """One placeable GPU set for a queued job (Algorithm 2's output).

    A ``NamedTuple`` rather than a frozen dataclass: candidate objects are
    created millions of times per production replay and tuple construction
    is ~3x cheaper than ``object.__setattr__``-per-field; equality/hash
    semantics over the same fields are unchanged."""

    node_id: int
    gpu_ids: Tuple[int, ...]
    utilization: float  # mean GPU utilization of the set (pre-allocation)
    resident_ids: Tuple[int, ...]
    # SKU terms (reference-node values when the fleet is homogeneous):
    # heterogeneity-aware rankers trade these against utilization
    speed: float = 1.0  # job-specific throughput multiplier on this node
    perf_per_watt: float = 1.0  # node perf per kW at its current frequency
    # the node's current relative DVFS frequency (1.0 = full clock);
    # ``speed`` and ``perf_per_watt`` already fold its slowdown in
    freq: float = 1.0
    # worst post-placement host-resource overshoot past the node supply
    # (percent points; 0.0 when within supply or host-blind) — host-aware
    # rankers prefer placements that do not stall the input pipeline
    host_over: float = 0.0

    @property
    def degree(self) -> int:
        """Number of jobs already resident on the candidate GPUs."""
        return len(self.resident_ids)


@dataclasses.dataclass(frozen=True)
class Thresholds:
    util: float = 80.0  # U_threshold (Eq. 3)
    mem: float = 80.0  # mem_threshold (Eq. 4)
    max_residents: int = 3  # co-location degree cap (4-way sharing measured
    # at +19-24% JCT; EaCO stays at <=4 jobs/GPU => 3 residents + newcomer)
    # node-level cap on combined host demand per resource (percent of
    # supply) after placement — the host-feasibility gate next to the
    # peak-HBM check.  Always satisfied by host-blind profiles (0 <= cap),
    # so the GPU-only candidate lists are byte-identical; ``math.inf``
    # disables the gate (host-blind scheduling of a host-aware world).
    host: float = HOST_OVERSUB_LIMIT


def _job_speed_ppw(node, profile, default_pm) -> Tuple[float, float]:
    """(speed, perf/watt) of ``profile`` on ``node`` — the exact reference
    expressions, with ``P(100, f)`` cached on the node."""
    speed = node.job_speed(profile)
    if node.freq < 1.0:
        # a frequency-capped node is slower for this job (sublinearly,
        # by its compute-boundedness) and cheaper per unit time
        speed = speed * dvfs.throughput_factor(node.freq, profile.gpu_util)
    ppw = speed / (node.p100_w(default_pm) / 1000.0)
    return speed, ppw


def _speed_ppw_memo(fleet, node, profile, default_pm) -> Tuple[float, float]:
    """``_job_speed_ppw`` memoized in the fleet by everything it reads:
    the node's SKU and frequency, the family's per-SKU speed table and its
    compute-boundedness (``gpu_util``, consulted below full clock).  Trace
    generators build a fresh ``JobProfile`` per job, so the key is by
    *value*, collapsing a million jobs to a few family x SKU entries."""
    key = (
        node.sku.name if node.sku is not None else None,
        node._freq,
        profile.sku_speed,
        profile.gpu_util,
    )
    got = fleet.speed_ppw.get(key)
    if got is None:
        got = fleet.speed_ppw[key] = _job_speed_ppw(node, profile, default_pm)
    return got


def find_candidates_reference(
    sim, job: Job, thresholds: Thresholds, allow_sleeping: bool = True,
    width: Optional[int] = None,
) -> List[Candidate]:
    """Algorithm 2 as a direct fleet scan (the differential-test oracle;
    also the fallback for simulators without columnar fleet state)."""
    out: List[Candidate] = []
    seen = set()  # (node_id, gpu_ids) — dedup without O(|out|) scans
    k = width or job.profile.n_gpus
    need = job.profile.peak_mem_util * k
    # host-feasibility gate (next to the peak-HBM ``need`` check): demand
    # is node-level, so one comparison per node — not per GPU set.  All
    # zeros for host-blind profiles: every gate passes, overshoot is 0.0.
    cpu_d = job.profile.cpu_util
    dram_d = job.profile.dram_util
    load_d = job.profile.loader_util
    host_cap = thresholds.host
    if cpu_d > host_cap or dram_d > host_cap or load_d > host_cap:
        return out  # the job alone busts the cap on any node
    idle_over = max(
        0.0, cpu_d - HOST_SUPPLY, dram_d - HOST_SUPPLY, load_d - HOST_SUPPLY
    )
    for node in sim.nodes:
        if node.state == NodeState.FAILED:
            continue
        if node.state == NodeState.SLEEP and not allow_sleeping:
            continue
        if k > node.n_gpus:
            continue
        if node.is_idle():
            # fast path for the common empty node: every GPU is eligible at
            # zero load, so hot == cold == the first k GPUs
            if need <= 100.0 * k:
                speed, ppw = _job_speed_ppw(node, job.profile, sim.power)
                out.append(
                    Candidate(
                        node.id, tuple(range(k)), 0.0, (),
                        speed=speed, perf_per_watt=ppw, freq=node.freq,
                        host_over=idle_over,
                    )
                )
            continue
        if (
            node.cpu_raw + cpu_d > host_cap
            or node.dram_raw + dram_d > host_cap
            or node.loader_raw + load_d > host_cap
        ):
            continue  # placing here would thrash the input pipeline
        speed, ppw = _job_speed_ppw(node, job.profile, sim.power)
        host_over = max(
            0.0,
            node.cpu_raw + cpu_d - HOST_SUPPLY,
            node.dram_raw + dram_d - HOST_SUPPLY,
            node.loader_raw + load_d - HOST_SUPPLY,
        )
        eligible = []
        residents_per = node.gpu_residents
        util_raw, peak_raw = node.util_raw, node.peak_raw
        for g in range(node.n_gpus):
            u = util_raw[g]
            if u > 100.0:
                u = 100.0
            m = peak_raw[g]
            if m > 100.0:
                m = 100.0
            if u > thresholds.util or m > thresholds.mem:
                continue  # Alg. 2 line 4: break on overloaded GPU
            if len(residents_per[g]) > thresholds.max_residents:
                continue
            eligible.append((u, 100.0 - m, g))
        if len(eligible) < k:
            continue
        eligible.sort()  # ascending utilization (ties: most free memory)
        for chosen in (eligible[-k:], eligible[:k]):  # hottest k, coldest k
            gpu_ids = tuple(sorted(g for _, _, g in chosen))
            key = (node.id, gpu_ids)
            if key in seen:
                continue
            # memory feasibility: accumulated available >= estimated demand
            if sum(a for _, a, _ in chosen) < need:
                continue
            residents = tuple(sorted(node.residents_on(gpu_ids)))
            if residents and len(residents) >= thresholds.max_residents:
                continue
            util = sum(u for u, _, _ in chosen) / k
            seen.add(key)
            out.append(
                Candidate(
                    node.id, gpu_ids, util, residents,
                    speed=speed, perf_per_watt=ppw, freq=node.freq,
                    host_over=host_over,
                )
            )
    return out


def find_candidates(
    sim, job: Job, thresholds: Thresholds, allow_sleeping: bool = True,
    width: Optional[int] = None, dedup_idle: bool = False,
) -> List[Candidate]:
    """Algorithm 2: the hottest-k and coldest-k eligible GPU sets per node
    meeting the utilization/memory thresholds for ``job`` (at ``width``
    GPUs when given, else the profile's reference width).

    Runs on the simulator's columnar fleet state when present (identical
    output, O(answer) instead of O(fleet)); ``dedup_idle`` additionally
    collapses idle nodes to one representative per equivalence class (see
    the module docstring for when that is byte-safe)."""
    fleet = getattr(sim, "fleet", None)
    if fleet is None:
        return find_candidates_reference(sim, job, thresholds, allow_sleeping, width)
    if not allow_sleeping and (fleet.sleep_idle or fleet.sleep_busy):
        # the columnar index sets fold sleeping nodes in; excluding them is
        # a cold path (EaCO always wakes sleepers) — take the full scan
        return find_candidates_reference(sim, job, thresholds, allow_sleeping, width)

    profile = job.profile
    k = width or profile.n_gpus
    need = profile.peak_mem_util * k
    nodes = sim.nodes
    default_pm = sim.power
    sku_speed, gpu_util = profile.sku_speed, profile.gpu_util
    spw_memo = fleet.speed_ppw
    # host-feasibility gate — same expressions and placement as the
    # reference scan (node-level, so it composes with the per-GPU caches
    # without touching their keys); all-zero profiles always pass
    cpu_d = profile.cpu_util
    dram_d = profile.dram_util
    load_d = profile.loader_util
    host_cap = thresholds.host
    if cpu_d > host_cap or dram_d > host_cap or load_d > host_cap:
        return []  # the job alone busts the cap on any node
    idle_over = max(
        0.0, cpu_d - HOST_SUPPLY, dram_d - HOST_SUPPLY, load_d - HOST_SUPPLY
    )

    # ---- idle node ids ----------------------------------------------------
    idle_ids: List[int] = []
    if need <= 100.0 * k:
        if dedup_idle:
            # one representative per idle class: the lowest id, i.e. the
            # member the full enumeration emits (and the ranked scan would
            # place on) first.  Throttled/degraded idle nodes are each
            # their own class — enumerate them individually.
            for key in fleet.idle_classes():
                if k > key[1]:
                    continue
                nid = fleet.idle_rep(key)
                if nid is not None:
                    idle_ids.append(nid)
            if fleet.odd_idle:
                for nid in fleet.odd_idle:
                    if k <= nodes[nid].n_gpus:
                        idle_ids.append(nid)
            idle_ids.sort()
        else:
            for nid in fleet.all_idle_ids():  # already ascending
                if k <= nodes[nid].n_gpus:
                    idle_ids.append(nid)
    base_gpus = tuple(range(k))

    # ---- merge (idle and busy id streams are disjoint and ascending) ------
    # emission order contract: ascending node id, per-node hottest-then-
    # coldest — exactly the reference scan's order
    thr_key = (thresholds.util, thresholds.mem, thresholds.max_residents)
    fleet.ensure_thr(thr_key)
    fparts = fleet.parts
    out: List[Candidate] = []
    append = out.append
    busy_ids = fleet.busy_ids()
    ii, ni = 0, len(idle_ids)
    bi, nb = 0, len(busy_ids)
    while True:
        if ii < ni and (bi >= nb or idle_ids[ii] < busy_ids[bi]):
            nid = idle_ids[ii]
            ii += 1
            node = nodes[nid]
            spw_key = (
                node.sku.name if node.sku is not None else None,
                node._freq, sku_speed, gpu_util,
            )
            sp = spw_memo.get(spw_key)
            if sp is None:
                sp = spw_memo[spw_key] = _job_speed_ppw(node, profile, default_pm)
            append(
                Candidate(
                    nid, base_gpus, 0.0, (), sp[0], sp[1], node._freq, idle_over
                )
            )
        elif bi < nb:
            nid = busy_ids[bi]
            bi += 1
            node = nodes[nid]
            if k > node.n_gpus:
                continue
            if (
                node.cpu_raw + cpu_d > host_cap
                or node.dram_raw + dram_d > host_cap
                or node.loader_raw + load_d > host_cap
            ):
                continue  # placing here would thrash the input pipeline
            by_width = fparts[nid]
            parts = by_width.get(k) if by_width is not None else None
            if parts is None:
                parts = fleet.cand_parts(node, k, thr_key)
            sp = None
            host_over = 0.0
            for gpu_ids, avail, residents, util_sum in parts:
                # memory feasibility: available >= estimated demand
                if avail < need:
                    continue
                if sp is None:
                    spw_key = (
                        node.sku.name if node.sku is not None else None,
                        node._freq, sku_speed, gpu_util,
                    )
                    sp = spw_memo.get(spw_key)
                    if sp is None:
                        sp = spw_memo[spw_key] = _job_speed_ppw(
                            node, profile, default_pm
                        )
                    host_over = max(
                        0.0,
                        node.cpu_raw + cpu_d - HOST_SUPPLY,
                        node.dram_raw + dram_d - HOST_SUPPLY,
                        node.loader_raw + load_d - HOST_SUPPLY,
                    )
                append(
                    Candidate(
                        nid, gpu_ids, util_sum / k, residents,
                        sp[0], sp[1], node._freq, host_over,
                    )
                )
        else:
            break
    return out
