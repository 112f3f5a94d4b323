"""Cluster node model: 8 accelerators, power states, GPU-granular residency.

Heterogeneous fleets: a node may carry a ``GPUSku`` (per-SKU power model and
throughput multiplier vs the V100 reference); ``sku=None`` keeps the exact
homogeneous reference behaviour.  Per-GPU utilization/memory composites are
maintained incrementally on residency changes so the hot paths (energy
accounting, candidate search) are O(1) per GPU instead of rescanning
residents.

Hot-path caching: the quantities the event loop reads millions of times —
instantaneous draw, mean node utilization, energy-attribution weights, the
full-clock draw ``P(100, f)`` — are cached on the node and invalidated by
the mutators that can change them (residency, state, frequency).  When the
node belongs to a simulator fleet, the same mutators notify the
``repro_torch.cluster.fleet.FleetState`` columns, which is how the simulator's
O(changed) power settlement and O(answer) candidate search stay in sync.
All cached values are produced by the exact pre-cache arithmetic, so every
read is bit-identical to recomputing.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.cluster import dvfs
from repro_torch.cluster.job import Job, JobProfile
from repro_torch.cluster.power import GPUSku, PowerModel


class NodeState:
    """Node lifecycle states (powered on / low-power sleep / failed)."""

    ON = "on"
    SLEEP = "sleep"
    FAILED = "failed"


class Node:
    """One 8-GPU node: residency, composites, DVFS state, energy ledger.

    A plain ``__slots__`` class (not a dataclass): ``state`` / ``freq`` /
    ``slowdown`` are properties whose setters invalidate the caches above
    and notify the owning ``FleetState`` (``fleet`` is None for
    free-standing nodes in tests, where every hook is skipped)."""

    __slots__ = (
        "id",
        "n_gpus",
        "sku",
        "_state",
        "gpu_residents",
        "energy_kwh",
        "last_account_time",
        "_slowdown",
        "_freq",
        "freq_step",
        "target_step",
        "util_raw",
        "mem_raw",
        "peak_raw",
        "cpu_raw",
        "dram_raw",
        "loader_raw",
        "_resident_count",
        "fleet",
        "_power_cache",
        "_util_cache",
        "_weights_cache",
        "_p100_cache",
    )

    def __init__(
        self,
        id: int,
        n_gpus: int = 8,
        sku: Optional[GPUSku] = None,
        state: str = NodeState.ON,
        energy_kwh: float = 0.0,
        last_account_time: float = 0.0,
        slowdown: float = 1.0,
        freq: float = 1.0,
        freq_step: Optional[int] = None,
        target_step: Optional[int] = None,
    ):
        self.id = id
        self.n_gpus = n_gpus
        self.sku = sku
        self._state = state
        # per-GPU resident job ids
        self.gpu_residents: List[Set[int]] = [set() for _ in range(n_gpus)]
        # energy accounting
        self.energy_kwh = energy_kwh
        self.last_account_time = last_account_time
        # degraded (straggler) multiplier on epoch times
        self._slowdown = slowdown
        # DVFS state: relative accelerator frequency (1.0 = the calibrated
        # full-clock operating point) and its ladder step; ``target_step``
        # is the scheduler-chosen step the power-cap enforcer may throttle
        # below but never raises above (None = the ladder top)
        self._freq = freq
        self.freq_step = freq_step
        self.target_step = target_step
        # incrementally-maintained raw (uncapped) per-GPU composites
        self.util_raw: List[float] = [0.0] * n_gpus
        self.mem_raw: List[float] = [0.0] * n_gpus
        self.peak_raw: List[float] = [0.0] * n_gpus
        # node-level host-resource composites (CPU cores / DRAM bandwidth /
        # dataloader throughput are shared per node, not per GPU): summed
        # resident demand in percent of supply, maintained in O(1) per
        # residency change like the per-GPU columns above
        self.cpu_raw = 0.0
        self.dram_raw = 0.0
        self.loader_raw = 0.0
        self._resident_count: Dict[int, int] = {}  # job id -> held GPUs
        self.fleet = None  # set by FleetState when owned by a simulator
        self._power_cache: Optional[Tuple[PowerModel, float]] = None
        self._util_cache: Optional[float] = None
        self._weights_cache = None  # ([(job id, weight)], total_weight)
        self._p100_cache: Optional[Tuple[PowerModel, float]] = None

    def __repr__(self) -> str:
        return (
            f"Node(id={self.id}, n_gpus={self.n_gpus}, "
            f"sku={self.sku_name!r}, state={self._state!r}, "
            f"residents={sorted(self._resident_count)})"
        )

    # -- cached-state properties --------------------------------------------

    @property
    def state(self) -> str:
        """Lifecycle state (``NodeState``); assignment invalidates the
        power cache and re-homes the node in the fleet index sets."""
        return self._state

    @state.setter
    def state(self, value: str) -> None:
        if value == self._state:
            return
        self._state = value
        self._power_cache = None
        if self.fleet is not None:
            self.fleet.on_state(self)

    @property
    def freq(self) -> float:
        """Relative DVFS frequency (1.0 = full clock); assignment
        invalidates the power caches and the fleet frequency column."""
        return self._freq

    @freq.setter
    def freq(self, value: float) -> None:
        if value == self._freq:
            return
        self._freq = value
        self._power_cache = None
        self._p100_cache = None
        if self.fleet is not None:
            self.fleet.on_freq(self)

    @property
    def slowdown(self) -> float:
        """Straggler multiplier on epoch times (1.0 = healthy)."""
        return self._slowdown

    @slowdown.setter
    def slowdown(self, value: float) -> None:
        if value == self._slowdown:
            return
        self._slowdown = value
        if self.fleet is not None:
            self.fleet.on_slowdown(self)

    # -- SKU ----------------------------------------------------------------

    @property
    def speed(self) -> float:
        """Fleet-default throughput multiplier of this node's SKU."""
        return self.sku.speed if self.sku else 1.0

    @property
    def sku_name(self) -> str:
        """This node's SKU name (``v100`` for the homogeneous reference
        fleet, which runs the V100 power model)."""
        return self.sku.name if self.sku else "v100"

    def job_speed(self, profile: JobProfile) -> float:
        """Throughput multiplier of ``profile`` on this node (the family's
        per-SKU override when present, else the SKU default)."""
        if self.sku is None:
            return 1.0
        return profile.speed_on(self.sku.name, self.sku.speed)

    def time_factor(self, profile: JobProfile) -> float:
        """Multiplier on reference epoch times for ``profile`` here:
        straggler slowdown x 1/SKU speed x the DVFS slowdown of the node's
        current frequency step.  Memoized in the owning fleet — the factor
        is a pure function of (slowdown, SKU, frequency, the family's
        per-SKU speed table, its compute-boundedness), so per-job profile
        objects collapse to a handful of family x node-class entries."""
        fleet = self.fleet
        if fleet is None:
            return self.time_factor_at(profile)
        key = (
            self._slowdown,
            self.sku.name if self.sku is not None else None,
            self._freq,
            profile.sku_speed,
            profile.gpu_util,
        )
        got = fleet.tf_memo.get(key)
        if got is None:
            got = fleet.tf_memo[key] = self.time_factor_at(profile)
        return got

    def time_factor_at(self, profile: JobProfile, freq: Optional[float] = None) -> float:
        """``time_factor`` evaluated at a hypothetical relative frequency
        ``freq`` (None = the node's current frequency) — what a
        frequency-aware scheduler scores candidate steps with."""
        f = self._freq if freq is None else freq
        base = self._slowdown / self.job_speed(profile)
        if f >= 1.0:
            return base
        return base * dvfs.time_multiplier(f, profile.gpu_util)

    def power_model(self, default: PowerModel) -> PowerModel:
        """This node's calibrated power model (its SKU's, else ``default``
        — the simulator-wide reference model)."""
        return self.sku.power if self.sku else default

    def current_power_w(self, jobs: Dict[int, Job], default: PowerModel) -> float:
        """Instantaneous draw (W) in the node's present state: sleep/idle
        housekeeping, zero when failed, else the frequency-adjusted
        ``P(U, f)`` of its residents' combined utilization.  Cached until
        the state / residency / frequency next changes."""
        cached = self._power_cache
        if cached is not None and cached[0] is default:
            return cached[1]
        pm = self.sku.power if self.sku else default
        state = self._state
        if state == NodeState.SLEEP:
            p = pm.sleep_w
        elif state == NodeState.FAILED:
            p = 0.0
        elif not self._resident_count:
            p = pm.idle_w
        else:
            p = pm.node_power_at(self.node_util(jobs), self._freq)
        self._power_cache = (default, p)
        return p

    def p100_w(self, default: PowerModel) -> float:
        """Full-utilization draw ``P(100, f)`` at the node's current
        frequency (the perf-per-watt denominator), cached per frequency."""
        cached = self._p100_cache
        if cached is not None and cached[0] is default:
            return cached[1]
        pm = self.sku.power if self.sku else default
        p = pm.node_power_at(100.0, self._freq)
        self._p100_cache = (default, p)
        return p

    # -- residency ---------------------------------------------------------

    def resident_job_ids(self) -> Set[int]:
        """Ids of every job holding at least one GPU here."""
        return set(self._resident_count)

    def residents_on(self, gpu_ids: Sequence[int]) -> Set[int]:
        """Ids of jobs resident on any of ``gpu_ids``."""
        out: Set[int] = set()
        for g in gpu_ids:
            out |= self.gpu_residents[g]
        return out

    def _residency_changed(self, was_idle: bool) -> None:
        self._power_cache = None
        self._util_cache = None
        self._weights_cache = None
        if self.fleet is not None:
            self.fleet.on_residency(
                self, was_idle != (not self._resident_count)
            )

    def add_job(self, job: Job, gpu_ids: Sequence[int]) -> None:
        """Place ``job`` on ``gpu_ids``, updating the composites in O(k)."""
        p = job.profile
        gu, mu, pk = p.gpu_util, p.mem_util, p.peak_mem_util
        util_raw, mem_raw, peak_raw = self.util_raw, self.mem_raw, self.peak_raw
        was_idle = not self._resident_count
        held = 0
        for g in gpu_ids:
            self.gpu_residents[g].add(job.id)
            util_raw[g] += gu
            mem_raw[g] += mu
            peak_raw[g] += pk
            held += 1
        self._resident_count[job.id] = held
        # host demand is node-level: counted once per job, not per GPU
        self.cpu_raw += p.cpu_util
        self.dram_raw += p.dram_util
        self.loader_raw += p.loader_util
        self._residency_changed(was_idle)

    def remove_job(self, job: Job) -> None:
        """Remove ``job`` from every GPU it holds (no-op if absent)."""
        if job.id not in self._resident_count:
            return
        p = job.profile
        was_idle = False  # had at least this resident
        for g, residents in enumerate(self.gpu_residents):
            if job.id in residents:
                residents.discard(job.id)
                self.util_raw[g] -= p.gpu_util
                self.mem_raw[g] -= p.mem_util
                self.peak_raw[g] -= p.peak_mem_util
                if not residents:  # squash float drift on empty GPUs
                    self.util_raw[g] = self.mem_raw[g] = self.peak_raw[g] = 0.0
        self.cpu_raw -= p.cpu_util
        self.dram_raw -= p.dram_util
        self.loader_raw -= p.loader_util
        self._resident_count.pop(job.id, None)
        if not self._resident_count:  # squash drift when the node empties
            self.cpu_raw = self.dram_raw = self.loader_raw = 0.0
        self._residency_changed(was_idle)

    def is_idle(self) -> bool:
        """True when no job holds any GPU here."""
        return not self._resident_count

    # -- utilization / power -------------------------------------------------

    def gpu_util(self, jobs: Dict[int, Job], gpu: int) -> float:
        """Combined duty-cycle utilization of one GPU, percent (capped)."""
        return min(100.0, self.util_raw[gpu])

    def gpu_mem_util(self, jobs: Dict[int, Job], gpu: int, peak: bool = True) -> float:
        """Combined (peak by default) memory utilization of one GPU."""
        return min(100.0, self.peak_raw[gpu] if peak else self.mem_raw[gpu])

    def node_util(self, jobs: Optional[Dict[int, Job]] = None) -> float:
        """Mean per-GPU utilization across the node, percent (cached until
        the next residency change)."""
        u = self._util_cache
        if u is None:
            if self.n_gpus == 0:
                u = 0.0
            else:
                u = sum(min(100.0, x) for x in self.util_raw) / self.n_gpus
            self._util_cache = u
        return u

    def node_mem_util(self, peak: bool = True) -> float:
        """Mean per-GPU (peak by default) memory utilization, percent."""
        if self.n_gpus == 0:
            return 0.0
        raw = self.peak_raw if peak else self.mem_raw
        return sum(min(100.0, m) for m in raw) / self.n_gpus

    def _attribution(self, jobs: Dict[int, Job]):
        """Energy-attribution weights of the current residents: a list of
        ``(job id, weight)`` in residency-insertion order plus their sum,
        cached until the next residency change (weights are a function of
        residency alone)."""
        cached = self._weights_cache
        if cached is None:
            items = [
                (j, max(jobs[j].profile.gpu_util, 1e-6) * held)
                for j, held in self._resident_count.items()
            ]
            total = 0.0
            for _, w in items:
                total += w
            cached = self._weights_cache = (items, total)
        return cached

    def account_energy(self, now: float, jobs: Dict[int, Job], power: PowerModel):
        """Settle energy up to ``now`` at the draw implied by the current
        state/utilization/frequency, attributing per-job shares by compute
        demand.  Called before every state change, so each interval accrues
        at the power that actually held over it."""
        dt = now - self.last_account_time
        if dt > 0:
            p = self.current_power_w(jobs, power)
            kwh = p * dt / 1000.0
            self.energy_kwh += kwh
            if self._resident_count and self._state == NodeState.ON:
                # per-job attribution: split the node draw by each resident's
                # compute demand (duty cycle x held GPUs).  Shares are a
                # function of residency alone, so a resize performed as
                # deallocate+allocate at the same instant attributes
                # identically to Simulator.resize().
                self._attribute(kwh, jobs)
        self.last_account_time = now

    def _attribute(self, kwh: float, jobs: Dict[int, Job]) -> None:
        """Credit ``kwh`` to the residents by their attribution weights."""
        items, total = self._attribution(jobs)
        for j, w in items:
            jobs[j].energy_kwh += kwh * w / total
