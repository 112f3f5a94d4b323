"""Discrete-event cluster simulator (the Gavel role in the paper's §6.2).

Event kinds: job arrival, epoch boundary, job completion, node failure /
repair, scheduler retries.  Job progress is piecewise-linear in time: every
allocation change re-rates the affected jobs (epoch time = exclusive epoch
time x co-location inflation x node slowdown), so energy and JCT respond to
co-location exactly as the calibrated model dictates.

The simulator is scheduler-agnostic: schedulers (EaCO and the three paper
baselines) hook arrival / epoch / completion events and mutate allocation
through the public ``allocate`` / ``deallocate`` API, which keeps energy
accounting and progress re-rating consistent for every policy.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.cluster import colocation, dvfs
from repro_torch.cluster.fleet import FleetState
from repro_torch.cluster.job import Job, JobProfile, JobState
from repro_torch.cluster.jobqueue import OrderedQueue
from repro_torch.cluster.node import Node, NodeState
from repro_torch.cluster.power import PowerModel, get_sku, v100_power_model
from repro_torch.control import messages as ctl
from repro_torch.control.plane import ControlPlane
from repro_torch.elastic import scaling
from repro_torch.obs.hub import TelemetryHub

# Events are plain ``(time, seq, kind, payload)`` tuples: the heap orders
# them by (time, seq) and seq is unique, so kind/payload never compare —
# tuple comparison in C replaced a Python-level ``__lt__`` that alone cost
# ~1 us per push/pop pair at 10k-job scale.


@dataclasses.dataclass
class SimConfig:
    n_nodes: int = 28
    gpus_per_node: int = 8
    # prediction noise: true inflation = model x (1 + U(-eps, +eps))
    prediction_noise: float = 0.10
    seed: int = 0
    # failures
    node_mtbf_hours: float = 0.0  # 0 = disabled
    node_repair_hours: float = 2.0
    straggler_prob: float = 0.0  # probability a repaired/initial node is slow
    straggler_factor: float = 1.5
    # bookkeeping
    active_node_sample_hours: float = 1.0
    # bound on the retained ``active_node_samples`` list (<=0 = unbounded):
    # when full it is decimated in place (every other sample dropped, the
    # sampling stride doubled), so memory is O(cap) on arbitrarily long
    # replays while ``avg_active_nodes`` — computed from O(1) running
    # accumulators over ALL samples — is unaffected
    active_node_sample_cap: int = 8192
    # hard co-location depth cap on the resize/migration path (the paper's
    # calibration stops at 4 jobs/GPU; schedulers' admission thresholds are
    # tighter still, and resizes must not exceed what admission would allow)
    resize_max_jobs_per_gpu: int = 4
    # heterogeneous fleet: per-node SKU names (len == n_nodes; see
    # ``power.fleet_skus`` for mix helpers).  None = homogeneous reference
    # fleet (the simulator-level ``power`` model, V100 by default).
    node_skus: Optional[Tuple[str, ...]] = None
    # cluster-wide instantaneous power cap (W); 0 = uncapped.  When set, a
    # ``dvfs.PowerCapEnforcer`` runs after every allocation-changing event:
    # it steps node frequencies down (least-SLO-risk residents first) until
    # the fleet draw fits, and back up when headroom returns.
    power_cap_w: float = 0.0


class Simulator:
    """The discrete-event cluster simulator (see the module docstring for
    the event model).  Schedulers mutate state only through ``allocate`` /
    ``deallocate`` / ``resize`` / ``set_frequency``; everything else —
    energy settlement, progress re-rating, cap enforcement — follows."""

    def __init__(
        self,
        cfg: SimConfig,
        scheduler,
        power: Optional[PowerModel] = None,
        hub: Optional[TelemetryHub] = None,
    ):
        self.cfg = cfg
        self.scheduler = scheduler
        self.power = power or v100_power_model()
        # telemetry: ``None`` when absent OR disabled, so every hook site
        # pays exactly one ``is not None`` check (the disabled-path golden
        # test locks that a disabled hub is indistinguishable from no hub)
        self.telemetry: Optional[TelemetryHub] = (
            hub if hub is not None and hub.enabled else None
        )
        self.rng = np.random.Generator(np.random.PCG64(cfg.seed))
        self.now = 0.0
        self._seq = 0
        self._heap: List[Tuple[float, int, str, Any]] = []
        if cfg.node_skus is not None and len(cfg.node_skus) != cfg.n_nodes:
            raise ValueError(
                f"node_skus has {len(cfg.node_skus)} entries for "
                f"{cfg.n_nodes} nodes"
            )
        self.nodes = [
            Node(
                i,
                cfg.gpus_per_node,
                sku=get_sku(cfg.node_skus[i]) if cfg.node_skus else None,
            )
            for i in range(cfg.n_nodes)
        ]
        # struct-of-arrays mirror of per-node state (power/freq columns,
        # state x idleness index sets, idle-class heaps): the hot loops
        # read these instead of rescanning ``self.nodes``
        self.fleet = FleetState(self.nodes)
        self.jobs: Dict[int, Job] = {}
        # arrival-ordered job ids awaiting allocation (O(1) remove/front-insert)
        self.queue = OrderedQueue()
        # per-job rate bookkeeping
        self._rate: Dict[int, float] = {}  # epochs/hour
        self._last_progress_t: Dict[int, float] = {}
        self._epoch_event_ver: Dict[int, int] = {}
        # true inflation noise per (signature) — deterministic
        self._true_noise: Dict[Tuple[str, ...], float] = {}
        # signature -> ground-truth inflation (pure function of the
        # signature and the seed, so memoizable across rerates)
        self._infl_cache: Dict[Tuple[str, ...], float] = {}
        # metrics: the retained sample list is bounded (see
        # ``active_node_sample_cap``); the average runs on exact O(1)
        # accumulators over every sample ever taken (integer counts sum
        # exactly in float division, so this matches np.mean bit-for-bit)
        self.active_node_samples: List[Tuple[float, int]] = []
        self._active_sum = 0
        self._active_count = 0
        self._active_stride = 1
        self._active_seen = 0
        self.deadline_violations: int = 0
        self.events_processed = 0
        self._dirty = False
        self._done_count = 0
        self._started = False  # first run() call arms failures + sampling
        # O(active) completion-stat accumulators (results() must not rescan
        # the full job table at 10k-job scale)
        self._jct_sum = 0.0
        self._jtt_sum = 0.0
        self._wait_sum = 0.0
        self._makespan = 0.0
        # elastic resizing
        self._pending_resize: Set[int] = set()  # job ids with a resize queued
        # per-job invalidation counter: bumped by deallocate so a pending
        # resize scored against the old placement can never fire
        self._resize_ver: Dict[int, int] = {}
        self.resize_skipped: int = 0  # requests that were stale at fire time
        # DVFS / power-cap bookkeeping: fleet draw is re-sampled (and the
        # cap enforced) only after events that can change it
        self._power_dirty = True
        self.peak_fleet_power_w = 0.0
        self.freq_change_count = 0
        self.power_cap = (
            dvfs.PowerCapEnforcer(cfg.power_cap_w) if cfg.power_cap_w > 0 else None
        )
        # serving manager attach point (repro_torch.serve): ``None`` when absent
        # OR disabled — the same one-check contract as ``telemetry``.
        # Serving-replica pseudo-jobs live in ``self.jobs`` (so placement,
        # co-location pricing and energy attribution are shared code) but
        # are excluded from training metrics and the epoch machinery.
        self.serve = None
        self._serve_ids: Set[int] = set()
        self._serve_done = 0
        # control plane (repro_torch.control): the execution layer every
        # decision component routes ScalePlans through, and the single
        # entry point for NodeEvents (Poisson MTBF and scripted faults)
        self.control = ControlPlane(self)
        # node ids with a Poisson failure event currently in the heap —
        # lets scripted and MTBF failures compose without double-arming
        # (or orphaning) a node's failure chain
        self._poisson_pending: Set[int] = set()
        # jobs killed with a checkpoint-restore delay: QUEUED but held out
        # of the wait queue until their ``requeue`` event fires
        self._restoring: Set[int] = set()
        # event dispatch table (kind -> bound handler): collected from every
        # ``_ev_<kind>`` method so subclass handlers register automatically;
        # run() falls back to getattr for kinds pushed after construction
        self._dispatch: Dict[str, Callable[[Any], None]] = {
            name[4:]: getattr(self, name)
            for name in dir(self)
            if name.startswith("_ev_")
        }
        if self.telemetry is not None:
            self.telemetry.set_fleet(
                [(n.id, n.sku_name, n.n_gpus) for n in self.nodes]
            )

    # ------------------------------------------------------------------ util

    def push(self, time: float, kind: str, payload: Any = None) -> None:
        """Enqueue an event (dispatched to ``_ev_<kind>`` at ``time``)."""
        self._seq += 1
        heapq.heappush(self._heap, (time, self._seq, kind, payload))

    def true_inflation(self, profiles: Sequence[JobProfile]) -> float:
        """Ground truth the simulator runs on: calibrated model + job-set
        noise (the reality EaCO's observation phase discovers).  Memoized by
        set signature — inflation is a pure function of (signature, seed)."""
        if len(profiles) <= 1:
            return colocation.inflation_factor(profiles)
        sig = colocation.set_signature(profiles)
        cached = self._infl_cache.get(sig)
        if cached is not None:
            return cached
        measured = colocation.measured_inflation(sig)
        if measured is not None:
            # the paper's own measured sets — and any bridge-calibrated
            # signatures registered with cluster.colocation — are exact
            out = measured
        else:
            if sig not in self._true_noise:
                # deterministic per signature ACROSS processes (python's
                # hash() is salted per interpreter — zlib.crc32 is stable)
                import zlib

                h = zlib.crc32(repr((sig, self.cfg.seed)).encode()) % 10_000 / 10_000.0
                self._true_noise[sig] = (h * 2 - 1) * self.cfg.prediction_noise
            out = colocation.inflation_factor(profiles) * (1 + self._true_noise[sig])
        self._infl_cache[sig] = out
        return out

    # ------------------------------------------------------------ allocation

    def _coresidents(self, job: Job) -> List[Job]:
        node = self.nodes[job.node_id]
        ids = node.residents_on(job.gpu_ids)
        return [self.jobs[i] for i in ids]

    def _rerate(self, node: Node) -> None:
        """Recompute rates for every resident of ``node`` after a change."""
        jobs = self.jobs
        rates = self._rate
        residents_on = node.residents_on
        serve_ids = self._serve_ids
        for jid in node.resident_job_ids():
            if jid in serve_ids:
                # replicas have no training rate or epoch events; their
                # profiles still inflate co-residents via residents_on
                continue
            job = jobs[jid]
            self._advance_progress(job)
            infl = self.true_inflation(
                [jobs[i].profile for i in residents_on(job.gpu_ids)]
            )
            # width-aware exclusive epoch time: identical to
            # profile.epoch_hours at the reference width
            excl_h = scaling.epoch_hours_at(job.profile, len(job.gpu_ids))
            epoch_h = excl_h * infl * node.time_factor(job.profile)
            rates[jid] = 1.0 / epoch_h
            self._schedule_epoch_event(job)

    def _advance_progress(self, job: Job) -> None:
        jid = job.id
        now = self.now
        t0 = self._last_progress_t.get(jid, now)
        if now > t0:
            rate = self._rate.get(jid)
            if rate:  # rates are strictly positive while a job runs
                job.epochs_done = min(
                    job.profile.epochs, job.epochs_done + rate * (now - t0)
                )
        self._last_progress_t[jid] = now

    @staticmethod
    def _next_epoch_boundary(done: float, total_epochs: int) -> float:
        """Epoch count of the next whole-epoch boundary after ``done`` (the
        single home of the boundary-rounding convention)."""
        return min(float(math.floor(done + 1e-9) + 1), float(total_epochs))

    def _projected_epochs(self, job: Job) -> float:
        """``epochs_done`` projected forward to ``now`` under the current
        rate (without mutating the lazy progress bookkeeping)."""
        rate = self._rate.get(job.id, 0.0)
        t0 = self._last_progress_t.get(job.id, self.now)
        return min(
            float(job.profile.epochs),
            job.epochs_done + rate * max(self.now - t0, 0.0),
        )

    def _schedule_epoch_event(self, job: Job) -> None:
        jid = job.id
        vers = self._epoch_event_ver
        ver = vers.get(jid, 0) + 1
        vers[jid] = ver
        rate = self._rate.get(jid)
        if not rate:
            return
        target = self._next_epoch_boundary(job.epochs_done, job.profile.epochs)
        dt = max(target - job.epochs_done, 0.0) / rate
        # hot path: push() inlined (one epoch event per epoch per job)
        self._seq += 1
        heapq.heappush(self._heap, (self.now + dt, self._seq, "epoch", (jid, ver)))

    def allocate(self, job: Job, node_id: int, gpu_ids: Sequence[int]) -> None:
        """Place ``job`` on ``gpu_ids`` of ``node_id`` now: wakes a sleeping
        node, settles its energy, starts/updates progress bookkeeping and
        re-rates every resident for the new co-location."""
        node = self.nodes[node_id]
        self._account_node(node)
        if node.state == NodeState.SLEEP:
            node.state = NodeState.ON  # wake on demand
        job.node_id = node_id
        job.gpu_ids = tuple(gpu_ids)
        if job.start_time is None:
            job.start_time = self.now
        job.state = JobState.RUNNING
        node.add_job(job, gpu_ids)
        if job.id in self.queue:
            self.queue.remove(job.id)
        self._last_progress_t[job.id] = self.now
        self._rerate(node)
        self._power_dirty = True
        if self.telemetry is not None:
            self.telemetry.job_event(
                self.now, "place", job.id, job.profile.name, node_id,
                len(job.gpu_ids), len(node.residents_on(job.gpu_ids)) - 1,
            )

    def deallocate(
        self,
        job: Job,
        to_queue: bool = True,
        checkpoint: bool = True,
        reason: str = "undo",
    ) -> None:
        """Remove a job from its node (EaCO undo / failure / completion).

        ``checkpoint``: keep whole-epoch progress (the paper's epoch-boundary
        checkpointing); otherwise progress since the last epoch is lost too.
        ``reason`` labels the telemetry record (``undo`` / ``failure`` /
        ``resize``) — it does not change behaviour.
        """
        node = self.nodes[job.node_id]
        self._account_node(node)
        if self.telemetry is not None:
            self.telemetry.job_event(
                self.now, "dealloc", job.id, job.profile.name, node.id,
                len(job.gpu_ids), detail=reason,
            )
        self._advance_progress(job)
        node.remove_job(job)
        if checkpoint:
            job.checkpointed_epochs = int(math.floor(job.epochs_done + 1e-9))
        # without a checkpoint, progress reverts to the last one taken
        job.epochs_done = float(job.checkpointed_epochs)
        self._rate.pop(job.id, None)
        self._epoch_event_ver[job.id] = self._epoch_event_ver.get(job.id, 0) + 1
        # any pending resize was scored against this placement: invalidate
        # it and free the slot so a fresh request can be issued immediately
        if job.id in self._pending_resize:
            self._pending_resize.discard(job.id)
            self._resize_ver[job.id] = self._resize_ver.get(job.id, 0) + 1
        job.node_id = None
        job.gpu_ids = ()
        if to_queue:
            job.state = JobState.QUEUED
            # undo returns to the FRONT (it already waited its turn)
            self.queue.insert(0, job.id)
        self._rerate(node)
        self._dirty = True
        self._power_dirty = True
        self.scheduler.on_node_freed(self, node)

    # ------------------------------------------------------------- resizing

    def pick_gpus(
        self, node: Node, k: int, job: Job, prefer_current: bool = True
    ) -> Optional[Tuple[int, ...]]:
        """Choose ``k`` GPUs on ``node`` for ``job``, or None if infeasible.

        Feasibility = no memory oversubscription: adding the job must keep
        every chosen GPU's combined peak memory (excluding the job's own
        current residency) within 100%, and (for host-aware profiles) the
        node's combined host demand within the oversubscription cap.
        Preference order: GPUs the job already holds (cheap resize), then
        the least-loaded.
        """
        prof = job.profile
        if prof.cpu_util or prof.dram_util or prof.loader_util:
            # node-level host gate (skipped entirely for host-blind
            # profiles): combined demand excluding the job's own residency
            cpu, dram, loader = node.cpu_raw, node.dram_raw, node.loader_raw
            if job.id in node._resident_count:
                cpu -= prof.cpu_util
                dram -= prof.dram_util
                loader -= prof.loader_util
            lim = colocation.HOST_OVERSUB_LIMIT
            if (
                cpu + prof.cpu_util > lim
                or dram + prof.dram_util > lim
                or loader + prof.loader_util > lim
            ):
                return None
        scored = []
        for g in range(node.n_gpus):
            others = [
                self.jobs[i].profile
                for i in node.gpu_residents[g]
                if i != job.id
            ]
            # raw (uncapped) sum: the combined model saturates at 100, which
            # would mask genuine oversubscription
            peak = sum(p.peak_mem_util for p in others) + job.profile.peak_mem_util
            if peak > 100.0:
                continue
            if len(others) + 1 > self.cfg.resize_max_jobs_per_gpu:
                continue  # deeper sharing than the calibrated model covers
            held = prefer_current and node.id == job.node_id and g in job.gpu_ids
            load = sum(p.peak_mem_util for p in others)
            scored.append((0 if held else 1, load, g))
        if len(scored) < k:
            return None
        scored.sort()
        return tuple(sorted(g for _, _, g in scored[:k]))

    def resize(self, job: Job, gpu_ids: Sequence[int], node_id: Optional[int] = None) -> None:
        """Resize (and optionally migrate) a running job, immediately.

        Semantically identical to ``deallocate(to_queue=False)`` followed by
        ``allocate`` at the same event time: progress snaps to the last
        whole-epoch checkpoint (zero loss when called at an epoch boundary),
        energy is settled on both nodes at ``now``, and every affected
        resident is re-rated.  Raises ``ValueError`` on any oversubscription
        or width-bound violation, leaving the simulation untouched.
        """
        if job.node_id is None or job.state not in (JobState.RUNNING, JobState.OBSERVING):
            raise ValueError(f"job {job.id} is not allocated")
        target = self.nodes[job.node_id if node_id is None else node_id]
        if target.state == NodeState.FAILED:
            raise ValueError(f"node {target.id} is failed")
        gpu_ids = tuple(sorted(gpu_ids))
        k = len(gpu_ids)
        if len(set(gpu_ids)) != k:
            raise ValueError(f"duplicate gpu ids {gpu_ids}")
        if not all(0 <= g < target.n_gpus for g in gpu_ids):
            raise ValueError(f"gpu ids {gpu_ids} out of range for node {target.id}")
        prof = job.profile
        if not prof.min_width <= k <= prof.max_width:
            raise ValueError(
                f"width {k} outside [{prof.min_width}, {prof.max_width}] "
                f"for job {job.id} ({prof.name})"
            )
        if prof.cpu_util or prof.dram_util or prof.loader_util:
            # node-level host gate (skipped for host-blind profiles):
            # migrating onto a host-saturated node would thrash its input
            # pipeline — same cap the admission path enforces
            cpu, dram, loader = target.cpu_raw, target.dram_raw, target.loader_raw
            if job.id in target._resident_count:
                cpu -= prof.cpu_util
                dram -= prof.dram_util
                loader -= prof.loader_util
            lim = colocation.HOST_OVERSUB_LIMIT
            if (
                cpu + prof.cpu_util > lim
                or dram + prof.dram_util > lim
                or loader + prof.loader_util > lim
            ):
                raise ValueError(
                    f"node {target.id} host demand oversubscribed by job {job.id}"
                )
        for g in gpu_ids:
            others = [
                self.jobs[i].profile
                for i in target.gpu_residents[g]
                if i != job.id
            ]
            if sum(p.peak_mem_util for p in others) + prof.peak_mem_util > 100.0:
                raise ValueError(
                    f"GPU {target.id}:{g} memory oversubscribed by job {job.id}"
                )
            if len(others) + 1 > self.cfg.resize_max_jobs_per_gpu:
                raise ValueError(
                    f"GPU {target.id}:{g} co-location degree would exceed "
                    f"{self.cfg.resize_max_jobs_per_gpu} jobs/GPU"
                )
        state = job.state
        self.deallocate(job, to_queue=False, checkpoint=True, reason="resize")
        self.allocate(job, target.id, gpu_ids)
        job.state = state  # preserve OBSERVING through the move
        job.resize_count += 1
        if self.telemetry is not None:
            self.telemetry.job_event(
                self.now, "resize", job.id, job.profile.name, target.id,
                len(gpu_ids),
            )

    def request_resize(
        self,
        job: Job,
        n_gpus: int,
        node_id: Optional[int] = None,
        expect_residents: Optional[Sequence[int]] = None,
    ) -> bool:
        """Schedule a resize at the job's next epoch boundary (the paper's
        checkpoint semantics: whole-epoch progress is never discarded).

        Target GPUs are chosen at fire time from then-current residency; the
        request is dropped (``resize_skipped``) if rates changed such that
        the fire time is no longer a boundary, or the target became
        infeasible.  ``expect_residents``: the co-resident job ids the
        caller's deadline/energy analysis assumed — the resize also aborts
        if any *other* job joined the chosen GPUs in the meantime (jobs
        leaving is always safe).  Returns False if the job cannot accept a
        resize now.
        """
        if job.id in self._pending_resize:
            return False
        if job.state != JobState.RUNNING:
            return False  # OBSERVING jobs must not move mid-window
        rate = self._rate.get(job.id)
        if not rate:
            return False
        prof = job.profile
        if not prof.min_width <= n_gpus <= prof.max_width:
            return False
        done_now = self._projected_epochs(job)
        target = self._next_epoch_boundary(done_now, prof.epochs)
        dt = max(target - done_now, 0.0) / rate
        self._pending_resize.add(job.id)
        self.push(
            self.now + dt,
            "resize",
            {
                "job": job.id,
                "n_gpus": n_gpus,
                "node": node_id,
                "rver": self._resize_ver.get(job.id, 0),
                "expect": None if expect_residents is None else tuple(expect_residents),
            },
        )
        return True

    def _ev_resize(self, payload):
        job = self.jobs[payload["job"]]
        if payload.get("rver") != self._resize_ver.get(job.id, 0):
            # the placement this request was scored against was torn down
            # (undo / failure); a fresh request may already be pending —
            # leave its bookkeeping alone
            self.resize_skipped += 1
            return
        self._pending_resize.discard(job.id)
        if job.state != JobState.RUNNING:
            return  # completed / undone / observing since the request
        node = self.nodes[job.node_id]
        self._account_node(node)
        self._advance_progress(job)
        frac = job.epochs_done - math.floor(job.epochs_done + 1e-9)
        if frac > 1e-6:
            self.resize_skipped += 1  # rates moved: not a boundary anymore
            return
        target_id = payload["node"] if payload["node"] is not None else job.node_id
        target = self.nodes[target_id]
        if target.state == NodeState.FAILED:
            self.resize_skipped += 1
            return
        gpu_ids = self.pick_gpus(target, payload["n_gpus"], job)
        if gpu_ids is None:
            self.resize_skipped += 1
            return
        expect = payload.get("expect")
        if expect is not None:
            actual = {
                i
                for i in target.residents_on(gpu_ids)
                if i != job.id and self.jobs[i].state != JobState.DONE
            }
            if not actual <= set(expect):
                # a job joined the target GPUs after the plan was scored:
                # its deadline was never checked against this co-location
                self.resize_skipped += 1
                return
        self.resize(job, gpu_ids, node_id=target_id)
        self._dirty = True

    def _account_node(self, node: Node) -> None:
        node.account_energy(self.now, self.jobs, self.power)

    def account_all(self) -> None:
        """Settle every node's energy up to ``now`` (end-of-run flush) in
        one vectorized pass: per-node kWh = power x dt / 1000 computed
        columnwise over the fleet power column.  Elementwise float64 ops
        are bit-identical to the scalar settlement they replace (locked by
        ``tests/test_fleet_vectorized.py``); per-job attribution still
        walks each settled node's residents."""
        nodes = self.nodes
        if not nodes:
            return
        now = self.now
        self.fleet_power_w()  # refresh the power column
        last = np.array([n.last_account_time for n in nodes], dtype=np.float64)
        p = np.array(self.fleet.power, dtype=np.float64)
        # .tolist() yields exact Python floats of the same bits
        kwh = (p * (now - last) / 1000.0).tolist()
        jobs = self.jobs
        for i, n in enumerate(nodes):
            if now > n.last_account_time:
                n.energy_kwh += kwh[i]
                if n._resident_count and n.state == NodeState.ON:
                    n._attribute(kwh[i], jobs)
            n.last_account_time = now

    def idle_on_node_ids(self) -> List[int]:
        """Ids of powered-on nodes with no residents, ascending (what the
        schedulers' sleep pass parks), read from the fleet index sets."""
        return sorted(self.fleet.on_idle)

    # ----------------------------------------------------------- DVFS / cap

    def fleet_power_w(self) -> float:
        """Instantaneous cluster draw (W) across all nodes, at their
        current states, utilizations and frequency steps.  Reads the fleet
        power column, recomputing only nodes whose draw-relevant state
        changed since the last call; the sum runs in node-id order, so the
        result is bit-identical to the full per-node scan it replaced."""
        fleet = self.fleet
        dirty = fleet.power_dirty
        if dirty:
            jobs, pm, nodes, power = self.jobs, self.power, self.nodes, fleet.power
            for i in dirty:
                power[i] = nodes[i].current_power_w(jobs, pm)
            dirty.clear()
        return sum(fleet.power)

    def set_frequency(self, node_id: int, step: int) -> None:
        """Clock ``node_id`` to ladder ``step`` immediately (scheduler
        action): energy is settled at the old frequency up to ``now``,
        every resident is re-rated at the new one, and the step becomes the
        node's ``target_step`` — the level the power-cap enforcer may
        throttle below but never raise above.  Also available as a pushed
        ``"set_frequency"`` event (payload ``{"node": id, "step": k}``)."""
        node = self.nodes[node_id]
        dvfs.node_ladder(node).freq(step)  # validate before mutating
        node.target_step = step
        self._apply_freq_step(node, step)

    def _apply_freq_step(self, node: Node, step: int) -> None:
        """Move ``node`` to ladder ``step`` without touching its target
        (the enforcer's entry point).  Settles energy first so the interval
        behind ``now`` accrues at the frequency that actually held."""
        freq = dvfs.node_ladder(node).freq(step)
        if node.freq_step == step or (node.freq_step is None and freq == node.freq):
            node.freq_step = step
            return
        self._account_node(node)
        node.freq = freq
        node.freq_step = step
        self.freq_change_count += 1
        if self.telemetry is not None:
            self.telemetry.freq_change(self.now, node.id, step, freq)
        self._rerate(node)
        self._dirty = True  # headroom moved: the scheduler may act on it
        self._power_dirty = True

    def _ev_set_frequency(self, payload):
        self.set_frequency(payload["node"], payload["step"])

    # ---------------------------------------------------------------- events

    def add_job(self, profile: JobProfile, arrival: float, deadline: float) -> Job:
        """Register a job and schedule its arrival event; returns it."""
        job = Job(id=len(self.jobs), profile=profile, arrival=arrival, deadline=deadline)
        self.jobs[job.id] = job
        self.push(arrival, "arrival", {"job": job.id})
        return job

    # ---------------------------------------------------------------- serving

    def register_serve_job(self, profile: JobProfile) -> Job:
        """Register a serving-replica pseudo-job (``repro_torch.serve``): a
        deadline-free job the manager places through ``allocate`` like any
        other, but which the simulator never rates, epochs or counts in
        training metrics.  No arrival event — the manager owns its
        lifecycle."""
        job = Job(
            id=len(self.jobs), profile=profile, arrival=self.now,
            deadline=math.inf,
        )
        self.jobs[job.id] = job
        self._serve_ids.add(job.id)
        return job

    def retire_serve_job(self, job: Job) -> None:
        """Mark a drained/evicted replica done (replicas bypass
        ``_complete`` — they carry no completion statistics)."""
        job.state = JobState.DONE
        job.finish_time = self.now
        self._done_count += 1
        self._serve_done += 1

    def _ev_request_batch(self, payload):
        """One inference arrival burst ``(family, n)``.  Pure accounting:
        the manager routes and folds latency without touching allocation
        state, so the event never marks the scheduler or power dirty —
        coalescing-contract-safe by construction."""
        if self.serve is None:
            raise RuntimeError(
                "request_batch event with no serving manager attached "
                "(load_request_stream requires ServeManager.attach first)"
            )
        self.serve.on_request_batch(self, payload)

    def _ev_serve_scale(self, _):
        """Periodic autoscaler tick (no-op if the manager detached)."""
        if self.serve is not None:
            self.serve.on_scale(self)

    def _serving_active(self) -> bool:
        """Whether the run loop must keep going for serving work even
        after every registered job is done (e.g. a serve-only replay
        between replica generations)."""
        return self.serve is not None and self.serve.active()

    def run(self, until: Optional[float] = None) -> None:
        """Drain events (up to ``until``, exclusive of later events) — the
        main loop: dispatch, re-schedule when allocation state moved,
        enforce the power cap / refresh the fleet-power peak when draw
        moved, stop early once every job is done.  Re-entrant: a paused
        run resumes exactly where it stopped."""
        if not self._started:
            # arm once: resuming a paused run must not re-schedule failures
            # or stack duplicate sample chains
            self._started = True
            if self.cfg.node_mtbf_hours > 0:
                for n in self.nodes:
                    self._schedule_failure(n)
            self.push(0.0, "sample", None)
        self._done_count = sum(1 for j in self.jobs.values() if j.state == JobState.DONE)
        tel = self.telemetry
        prof = tel.profiler if tel is not None else None
        heap = self._heap
        heappop = heapq.heappop
        dispatch = self._dispatch
        jobs = self.jobs
        while heap:
            if jobs and self._done_count == len(jobs) and not self._serving_active():
                # everything already finished (e.g. a run() call after a
                # pause landed past the last completion): leave trailing
                # bookkeeping events unprocessed, exactly as the in-loop
                # break below does
                break
            t = heap[0][0]
            if until is not None and t > until:
                # not ours to process: leave it queued so a later run()
                # resumes exactly where this one paused
                break
            self.now = t
            # same-timestamp batch: drain every event at exactly this time,
            # then run scheduling / cap enforcement once for the batch (the
            # event-coalescing contract — see docs/architecture.md)
            while True:
                _, _, kind, payload = heappop(heap)
                self.events_processed += 1
                handler = dispatch.get(kind)
                if handler is None:
                    handler = getattr(self, f"_ev_{kind}")
                if prof is None:
                    handler(payload)
                else:
                    t0 = time.perf_counter()
                    handler(payload)
                    prof.record(kind, time.perf_counter() - t0)
                if (
                    not heap
                    or heap[0][0] != t
                    or (
                        self._done_count == len(jobs)
                        and not self._serving_active()
                    )
                ):
                    break
            # reschedule only when allocation-relevant state changed — epoch
            # ticks alone cannot unblock a queued job (thresholds move on
            # completion/undo/repair), and scanning candidates on every epoch
            # event is O(queue x gpus) in Python.
            if self._dirty:
                self._dirty = False
                if prof is None:
                    self.scheduler.try_schedule(self)
                else:
                    t0 = time.perf_counter()
                    self.scheduler.try_schedule(self)
                    prof.record("try_schedule", time.perf_counter() - t0)
            # fleet power only moves on allocation / state / frequency
            # changes: enforce the cap and refresh the peak exactly then,
            # still within the same event timestamp
            if self._power_dirty:
                if self.power_cap is not None:
                    if prof is None:
                        self.power_cap.enforce(self)
                    else:
                        t0 = time.perf_counter()
                        self.power_cap.enforce(self)
                        prof.record("cap_enforce", time.perf_counter() - t0)
                self._power_dirty = False
                p = self.fleet_power_w()
                if p > self.peak_fleet_power_w:
                    self.peak_fleet_power_w = p
                if tel is not None:
                    tel.fleet_power_sample(self.now, p)
            if self._done_count == len(jobs) and not self._serving_active():
                break
        self.account_all()

    def _record_active_sample(self, t: float, active: int) -> None:
        """Fold one active-node sample: exact running accumulators always;
        the retained list only every ``_active_stride``-th sample, decimated
        in place (drop every other, double the stride) when it reaches
        ``active_node_sample_cap``."""
        self._active_sum += active
        self._active_count += 1
        if self._active_seen % self._active_stride == 0:
            cap = self.cfg.active_node_sample_cap
            if cap > 0 and len(self.active_node_samples) >= cap:
                del self.active_node_samples[1::2]
                self._active_stride *= 2
                keep = (self._active_seen % self._active_stride) == 0
            else:
                keep = True
            if keep:
                self.active_node_samples.append((t, active))
        self._active_seen += 1

    def _ev_sample(self, _):
        # |ON| == |on idle| + |on busy| from the fleet index sets: O(1)
        # instead of a fleet scan per sample tick
        active = len(self.fleet.on_idle) + len(self.fleet.on_busy)
        self._record_active_sample(self.now, active)
        tel = self.telemetry
        if tel is not None:
            tel.gauge(self.now, "active_nodes", active)
            tel.gauge(self.now, "queued_jobs", len(self.queue))
            if tel.cfg.node_samples:
                for n in self.nodes:
                    tel.node_sample(
                        self.now, n.id, n.current_power_w(self.jobs, self.power),
                        n.node_util(self.jobs), n.node_mem_util(), n.freq,
                        n.state,
                    )
        if self._done_count < len(self.jobs) or self._serving_active():
            self.push(self.now + self.cfg.active_node_sample_hours, "sample", None)

    def _ev_arrival(self, payload):
        job = self.jobs[payload["job"]]
        self.queue.append(job.id)
        self._dirty = True
        if self.telemetry is not None:
            self.telemetry.job_event(
                self.now, "submit", job.id, job.profile.name,
                n_gpus=job.profile.n_gpus,
            )
        self.scheduler.on_arrival(self, job)

    def _ev_epoch(self, payload):
        jid, ver = payload
        if ver != self._epoch_event_ver.get(jid):
            return  # stale (rates changed since scheduling)
        job = self.jobs[jid]
        if job.state not in (JobState.RUNNING, JobState.OBSERVING):
            return
        node = self.nodes[job.node_id]
        self._account_node(node)
        self._advance_progress(job)
        job.checkpointed_epochs = int(math.floor(job.epochs_done + 1e-9))
        if job.epochs_done >= job.profile.epochs - 1e-9:
            self._complete(job)
        else:
            self.scheduler.on_epoch(self, job)
            self._schedule_epoch_event(job)

    def _complete(self, job: Job) -> None:
        node = self.nodes[job.node_id]
        self._account_node(node)
        node.remove_job(job)
        self._rate.pop(job.id, None)
        job.state = JobState.DONE
        job.finish_time = self.now
        self._done_count += 1
        self._dirty = True
        self._jct_sum += job.jct()
        self._jtt_sum += job.jtt()
        self._wait_sum += job.start_time - job.arrival
        self._makespan = max(self._makespan, job.finish_time)
        if job.finish_time > job.deadline:
            self.deadline_violations += 1
        if self.telemetry is not None:
            self.telemetry.job_event(
                self.now, "complete", job.id, job.profile.name, node.id,
                len(job.gpu_ids),
            )
            if self.telemetry.audit is not None:
                self.telemetry.audit.on_complete(job, self.now)
        job.node_id = None
        self._rerate(node)
        self._power_dirty = True
        self.scheduler.on_complete(self, job)
        self.scheduler.on_node_freed(self, node)

    # --------------------------------------------------------------- failures

    def _schedule_failure(self, node: Node) -> None:
        """Arm the node's Poisson MTBF failure chain (one event in flight
        per node, tracked in ``_poisson_pending`` so scripted failures
        compose — see ``_apply_node_event``)."""
        dt = float(self.rng.exponential(self.cfg.node_mtbf_hours))
        self._poisson_pending.add(node.id)
        self.push(self.now + dt, "failure", {"node": node.id})

    def _ev_failure(self, payload):
        node = self.nodes[payload["node"]]
        self._poisson_pending.discard(node.id)
        if node.state == NodeState.FAILED:
            # a scripted failure took the node down first: nothing to
            # kill, and the repair that brings it back re-arms the chain
            # (the node is not in _poisson_pending anymore)
            return
        self.control.node_event(
            ctl.NodeEvent(kind=ctl.FAIL, node_id=node.id, cause="mtbf")
        )

    def _ev_repair(self, payload):
        self.control.node_event(
            ctl.NodeEvent(
                kind=ctl.REPAIR,
                node_id=payload["node"],
                cause=payload.get("cause", "mtbf") if payload else "mtbf",
            )
        )

    def _ev_node_event(self, payload):
        """A scripted ``NodeEvent`` pushed into the heap (the
        ``FaultInjector``'s arm path and ``LiveLoop.inject``)."""
        self.control.node_event(payload)

    def _ev_requeue(self, payload):
        """Checkpoint-restore completed: the held-out victim re-enters
        the wait queue at the front (it already waited its turn)."""
        jid = payload["job"]
        self._restoring.discard(jid)
        job = self.jobs[jid]
        if job.state != JobState.QUEUED or jid in self.queue:
            return  # completed or re-queued through another path meanwhile
        self.queue.insert(0, jid)
        self._dirty = True

    def _kill_training_job(self, job: Job, restore_delay_h: float, reason: str) -> None:
        """Involuntary undo of one training victim: resume from the last
        epoch checkpoint, immediately (legacy failure path) or after a
        checkpoint-restore delay (the job sits in ``_restoring`` limbo —
        QUEUED but not placeable — until its ``requeue`` event)."""
        if restore_delay_h <= 0.0:
            self.deallocate(job, to_queue=True, checkpoint=True, reason=reason)
        else:
            self.deallocate(job, to_queue=False, checkpoint=True, reason=reason)
            job.state = JobState.QUEUED
            self._restoring.add(job.id)
            self.push(self.now + restore_delay_h, "requeue", {"job": job.id})
        job.restart_count += 1

    def _apply_node_event(self, ev) -> None:
        """Execution-layer handler for one ``NodeEvent`` — the only fault
        path (both the Poisson MTBF events and scripted scenarios land
        here, via ``ControlPlane.node_event``).

        Composition rules: a ``fail`` on an already-FAILED node and a
        ``repair`` on a non-FAILED node are no-ops (scripted and Poisson
        streams never double-kill or double-repair); a repair re-arms the
        Poisson chain only when no failure event is already in flight for
        the node.  Only ``cause == "mtbf"`` repairs draw from the
        simulator RNG (the legacy straggler draw) — scripted events are
        fully deterministic.
        """
        node = self.nodes[ev.node_id]
        if ev.kind == ctl.FAIL:
            if node.state == NodeState.FAILED:
                return  # already down: scripted + Poisson compose, no double kill
            self._account_node(node)
            victims = [self.jobs[i] for i in node.resident_job_ids()]
            for job in victims:
                if job.id in self._serve_ids:
                    # replicas die with the node: their traffic re-pends and
                    # the autoscaler re-provisions on its next tick
                    self.serve.on_replica_failure(self, job)
                    continue
                # involuntary undo: resume from the last epoch checkpoint
                self._kill_training_job(job, ev.restore_delay_h, "failure")
            node.state = NodeState.FAILED
            self._power_dirty = True
            repair_h = (
                ev.repair_h if ev.repair_h is not None else self.cfg.node_repair_hours
            )
            if math.isfinite(repair_h):
                self.push(
                    self.now + repair_h,
                    "repair",
                    {"node": node.id, "cause": ev.cause},
                )
        elif ev.kind == ctl.REPAIR:
            if node.state != NodeState.FAILED:
                return  # stale: a scripted repair already brought it back
            self._account_node(node)
            node.state = NodeState.ON
            self._dirty = True
            self._power_dirty = True
            if ev.cause == "mtbf":
                node.slowdown = (
                    self.cfg.straggler_factor
                    if self.rng.random() < self.cfg.straggler_prob
                    else 1.0
                )
            else:
                node.slowdown = ev.factor
            if self.cfg.node_mtbf_hours > 0 and node.id not in self._poisson_pending:
                self._schedule_failure(node)
            self.scheduler.on_node_freed(self, node)
        elif ev.kind == ctl.PREEMPT:
            if node.state != NodeState.ON:
                return  # nothing runs on a failed/sleeping node
            self._account_node(node)
            if ev.job_ids:
                victims = [
                    self.jobs[j]
                    for j in ev.job_ids
                    if self.jobs[j].node_id == node.id
                    and j not in self._serve_ids
                ]
            else:
                victims = [
                    self.jobs[i]
                    for i in node.resident_job_ids()
                    if i not in self._serve_ids
                ]
            for job in victims:
                self._kill_training_job(job, ev.restore_delay_h, "preempt")
        elif ev.kind == ctl.STRAGGLE:
            if node.state == NodeState.FAILED:
                return  # degradation is moot while the node is down
            self._account_node(node)
            node.slowdown = ev.factor
            self._rerate(node)
            self._dirty = True  # the Brain may migrate off the slow node
        else:  # pragma: no cover - messages.NodeEvent validates kinds
            raise ValueError(f"unknown NodeEvent kind {ev.kind!r}")

    def _ev_retry(self, _):
        # a scheduler-requested wake-up (e.g. a narrow-admission patience
        # window expiring): mark dirty so try_schedule actually runs
        self._dirty = True

    # ---------------------------------------------------------------- results

    def results(self) -> Dict[str, Any]:
        """Headline metrics of the replay so far (energy, JCT/JTT/wait,
        makespan, violations, undo/restart/resize counters, peak fleet
        power and DVFS/cap activity)."""
        # completion stats come from O(1) accumulators maintained at
        # completion time; the single remaining pass over the job table only
        # folds static per-job counters (schedulers bump them in place) and
        # runs once per results() call, not once per event.
        # serving pseudo-jobs are excluded from every training metric (the
        # set is empty — and the checks free — when serving is off; the
        # byte-identity test locks disabled == absent); per-request serving
        # metrics live under the "serve" key, present only when a manager
        # is attached
        n_done = self._done_count - self._serve_done
        serve_ids = self._serve_ids
        total_e = sum(n.energy_kwh for n in self.nodes)
        undo = restart = resize = 0
        job_e = 0.0
        for j in self.jobs.values():
            if j.id in serve_ids:
                continue
            undo += j.undo_count
            restart += j.restart_count
            resize += j.resize_count
            job_e += j.energy_kwh
        out = {
            "total_energy_kwh": total_e,
            "jobs_done": n_done,
            "jobs_total": len(self.jobs) - len(serve_ids),
            "avg_jct_h": self._jct_sum / n_done if n_done else 0.0,
            "avg_jtt_h": self._jtt_sum / n_done if n_done else 0.0,
            "avg_wait_h": self._wait_sum / n_done if n_done else 0.0,
            "makespan_h": self._makespan,
            # integer samples sum exactly in float64, so the running
            # accumulators reproduce np.mean over the full sample stream
            # bit-for-bit even after the retained list is decimated
            "avg_active_nodes": (
                float(np.float64(self._active_sum) / np.float64(self._active_count))
                if self._active_count
                else 0.0
            ),
            "deadline_violations": self.deadline_violations,
            "undo_count": undo,
            "restart_count": restart,
            "resize_count": resize,
            "job_energy_kwh": job_e,
            "peak_fleet_power_w": self.peak_fleet_power_w,
            "power_cap_w": self.cfg.power_cap_w,
            "freq_change_count": self.freq_change_count,
            "cap_throttle_count": self.power_cap.throttle_count if self.power_cap else 0,
            "cap_raise_count": self.power_cap.raise_count if self.power_cap else 0,
            "cap_infeasible_events": (
                self.power_cap.infeasible_events if self.power_cap else 0
            ),
        }
        # present ONLY when event-loop profiling was armed, so the results
        # dict stays byte-identical for every non-profiling run
        if self.telemetry is not None and self.telemetry.profiler is not None:
            out["profile"] = self.telemetry.profiler.summary()
        # present ONLY when a serving manager is attached (same contract)
        if self.serve is not None:
            out["serve"] = self.serve.summary()
        return out
