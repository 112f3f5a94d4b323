"""EaCO: Energy-aware CO-allocating algorithm (the paper's Algorithm 1).

Flow per queued job j (Schedule(j)):
  1. ``FindCandidates`` -> list L of GPU sets meeting j's requirements and
     the utilization/memory thresholds (Alg. 2);
  2. inner loop: take the candidate with the HIGHEST utilization (pack the
     hottest node so cold nodes can sleep), ``PredictJCT`` for all jobs
     co-located there + j; allocate only if every deadline holds (Eq. 2);
  3. early-stage observation: keep j tentative until one epoch has passed
     for every co-located job since allocation; refine the JCT estimate
     from the *measured* rates, record the measurement into H;
  4. if the refined estimate violates any deadline, UNDO at the epoch
     boundary (progress is checkpointed) and retry from step 2 with the
     failed set excluded; otherwise finalize.

Energy action: idle nodes transition to the low-power state; candidates may
include sleeping nodes (woken on allocation).  Both behaviours are what the
paper's §4/§6.2 attribute EaCO's energy savings to.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.cluster.job import Job, JobState
from repro_torch.cluster.node import Node, NodeState
from repro_torch.control import messages as ctl
from repro_torch.core.candidates import Candidate, Thresholds, find_candidates
from repro_torch.core.history import History
from repro_torch.core.predictor import JCTPredictor
from repro_torch.elastic import scaling


def _rank_key(c: Candidate) -> Tuple[float, float, float]:
    """EaCO's candidate sort key (shared by the full ``_rank`` sort and the
    first-candidate fast path in ``schedule_job`` — both must agree):
    hottest first, then least host-oversubscribed, then best perf/watt.
    ``host_over`` is a constant 0.0 for host-blind profiles, so the
    GPU-only ordering is untouched."""
    return (-c.utilization, c.host_over, -c.perf_per_watt)


def _rank_key_blind(c: Candidate) -> Tuple[float, float]:
    """The pre-host sort key — what a host-blind EaCO ranks with."""
    return (-c.utilization, -c.perf_per_watt)


@dataclasses.dataclass
class _Observation:
    node_id: int
    gpu_ids: Tuple[int, ...]
    epochs_at_alloc: Dict[int, int]  # job id -> whole epochs when j arrived
    failed_sets: Set[Tuple[int, Tuple[int, ...]]]


class EaCO:
    """Scheduler implementing the paper's Algorithm 1."""

    name = "eaco"
    sleeps_idle_nodes = True
    # Idle nodes of one (SKU, gpu-count) class are indistinguishable to this
    # ranker (utilization 0, class-determined speed/perf-per-watt/freq) and
    # to the Eq. 2 gate, so FindCandidates may emit just the lowest-id
    # representative per class — the exact node the full list would pick.
    # Index-budgeted subclasses (EaCOPowerCap) must turn this off.
    idle_candidate_dedup = True

    def __init__(
        self,
        thresholds: Optional[Thresholds] = None,
        history: Optional[History] = None,
        alpha: float = 0.5,
        queue_window: int = 0,
        host_aware: bool = True,
    ):
        self.thresholds = thresholds or Thresholds()
        # host_aware=False is the ablation arm for benchmarks: the
        # scheduler ignores host demand entirely — no admission cap, the
        # pre-host rank key, a host-blind analytic predictor — while the
        # simulated world still pays the contention.  With host-blind
        # profiles (all zeros) both modes are byte-identical.
        self.host_aware = host_aware
        if not host_aware:
            self.thresholds = dataclasses.replace(self.thresholds, host=math.inf)
        self._rank_fn = _rank_key if host_aware else _rank_key_blind
        self.history = history if history is not None else History()
        self.predictor = JCTPredictor(self.history, host_aware=host_aware)
        self.alpha = alpha
        # production-scale knob: only the first ``queue_window`` waiting
        # jobs are considered per pass (0 = unlimited, the paper setting).
        # Bounds the O(queue x nodes) scan during burst backlogs at 10k-job
        # scale without touching steady-state behaviour.
        self.queue_window = queue_window
        self._obs: Dict[int, _Observation] = {}  # job id -> observation state
        self._obs_by_node: Dict[int, Set[int]] = {}  # node id -> observing jobs
        self._failed: Dict[int, Set[Tuple[int, Tuple[int, ...]]]] = {}

    # ------------------------------------------------------------- selection

    def _rank(self, candidates: List[Candidate]) -> List[Candidate]:
        """Highest utilization first (Alg. 1 line 5); among equally hot
        sets, prefer less host oversubscription, then the SKU with the
        best perf/watt — on a heterogeneous fleet the same packing
        decision is cheaper in joules there."""
        return sorted(candidates, key=self._rank_fn)

    def _admit(
        self, sim, job: Job, cand: Candidate, width: Optional[int] = None,
        freq: Optional[float] = None,
    ) -> bool:
        """Eq. (2) gate for placing ``job`` on ``cand``: every co-located
        deadline must hold (optionally evaluated at relative frequency
        ``freq`` instead of the node's current step)."""
        residents = [sim.jobs[i] for i in cand.resident_ids]
        node = sim.nodes[cand.node_id]
        # width map: residents run at their allocated widths (== reference
        # for every rigid job); the newcomer at the requested width
        widths = {j.id: len(j.gpu_ids) for j in residents if j.gpu_ids}
        if width:
            widths[job.id] = width
        return self.predictor.deadlines_met(
            sim.now, [job, *residents], node, widths=widths or None, freq=freq
        )

    def _choose(
        self, sim, job: Job, ranked: List[Candidate], width: Optional[int]
    ) -> Optional[Candidate]:
        """Pick the candidate to place ``job`` on (Alg. 1's inner loop):
        the first ranked set whose co-location keeps every deadline.
        Subclasses override this to optimize jointly over more knobs (e.g.
        ``EaCOPowerCap`` adds the frequency step)."""
        for cand in ranked:
            if self._admit(sim, job, cand, width):
                return cand
        return None

    def _on_placed(self, sim, job: Job, cand: Candidate) -> None:
        """Hook invoked right after ``job`` lands on ``cand`` (no-op here;
        ``EaCOPowerCap`` applies its chosen frequency step)."""

    def _audit_decision(
        self, sim, job: Job, cand: Candidate, n_candidates: int, reason: str
    ) -> None:
        """Record the placement into the decision-audit log (no-op without
        telemetry).  Read-only: the predicted inflation re-runs the trust
        chain with ``count=False`` so H hit/miss stats stay untouched, and
        the realized inflation reads the simulator's memoized ground truth
        — the same value ``allocate`` just re-rated the residents with."""
        tel = sim.telemetry
        if tel is None or tel.audit is None:
            return
        node = sim.nodes[cand.node_id]
        profiles = [job.profile, *(sim.jobs[i].profile for i in cand.resident_ids)]
        predicted = self.predictor.predict_inflation(profiles, count=False)
        realized = sim.true_inflation(profiles)
        excl_h = scaling.epoch_hours_at(
            job.profile, len(job.gpu_ids) or job.profile.n_gpus
        )
        predicted_finish = sim.now + job.remaining_epochs * (
            excl_h * predicted * node.time_factor(job.profile)
        )
        tel.audit.decision(
            sim.now, self.name, job, node.sku_name, cand.node_id,
            len(job.gpu_ids), len(cand.resident_ids), n_candidates,
            node.freq, predicted, realized, predicted_finish, reason=reason,
        )

    def schedule_job(
        self, sim, job: Job, width: Optional[int] = None, reason: str = "queue"
    ) -> bool:
        """One pass of Alg. 1's nested loops for job j. True if allocated.

        ``reason`` labels the admission path in the decision audit
        (``queue`` for the normal drain, ``narrow`` for elastic
        narrow-width admission)."""
        failed = self._failed.setdefault(job.id, set())
        # dedup only while the failed set is empty: an excluded idle set
        # must not silence its whole class (another member would still be
        # admissible in the full enumeration)
        cands = find_candidates(
            sim, job, self.thresholds, width=width,
            dedup_idle=self.idle_candidate_dedup and not failed,
        )
        if failed:
            cands = [c for c in cands if (c.node_id, c.gpu_ids) not in failed]
        cls = type(self)
        if cands and cls._rank is EaCO._rank and cls._choose is EaCO._choose:
            # Fast path when neither the ranking nor the choice is
            # overridden: the top-ranked candidate almost always admits, so
            # find it in one O(n) ``min`` pass and only materialize the
            # full sort if its Eq. 2 gate fails.  ``min`` keeps the first
            # minimal element, exactly like the stable sort's front — the
            # admission sequence (and its History side effects) is
            # identical to scanning the ranked list.
            best = min(cands, key=self._rank_fn)
            if self._admit(sim, job, best, width):
                cand = best
            else:
                cand = None
                for c in self._rank(cands)[1:]:
                    if self._admit(sim, job, c, width):
                        cand = c
                        break
        else:
            cand = self._choose(sim, job, self._rank(cands), width)
        if cand is None:
            return False
        # the placement decision leaves as a ScalePlan message: the control
        # plane is the only component that mutates allocation state
        sim.control.submit(
            ctl.ScalePlan(
                self.name, (ctl.place(job.id, cand.node_id, cand.gpu_ids),)
            )
        )
        if cand.resident_ids:
            # tentative: observe one epoch of every co-located job
            job.state = JobState.OBSERVING
            self._drop_obs(job.id)  # stale window from a torn-down placement
            self._obs[job.id] = _Observation(
                node_id=cand.node_id,
                gpu_ids=cand.gpu_ids,
                epochs_at_alloc={
                    i: sim.jobs[i].checkpointed_epochs
                    for i in (*cand.resident_ids, job.id)
                },
                failed_sets=failed,
            )
            self._obs_by_node.setdefault(cand.node_id, set()).add(job.id)
        self._on_placed(sim, job, cand)
        # after _on_placed so the audited frequency is the applied step
        self._audit_decision(sim, job, cand, len(cands), reason)
        return True

    def _drop_obs(self, jid: int) -> None:
        obs = self._obs.pop(jid, None)
        if obs is not None:
            peers = self._obs_by_node.get(obs.node_id)
            if peers is not None:
                peers.discard(jid)
                if not peers:
                    del self._obs_by_node[obs.node_id]

    # ------------------------------------------------------------ sim hooks

    def on_arrival(self, sim, job: Job) -> None:
        """No-op: try_schedule drains the queue after every event."""

    def try_schedule(self, sim) -> None:
        """Drain the wait queue (one forward pass) and sleep empty nodes."""
        # Single forward pass: allocation only ever consumes capacity and
        # inflates residents, so a job that failed earlier in the pass
        # cannot succeed later in it — the old restart-on-progress loop
        # re-scanned the whole queue O(q) times for identical decisions.
        if sim.queue:
            unplaced = 0
            for jid in sim.queue.first_n(self.queue_window):
                job = sim.jobs[jid]
                if job.state != JobState.QUEUED:
                    continue
                if not self.schedule_job(sim, job):
                    unplaced += 1
            serve = getattr(sim, "serve", None)
            if unplaced and serve is not None:
                # training starving while replicas hold capacity: signal
                # the serving manager (it evicts at its next tick, so the
                # freed GPUs re-enter placement inside a normal event step)
                serve.on_training_pressure(sim, unplaced)
        self._sleep_idle(sim)

    def on_epoch(self, sim, job: Job) -> None:
        """Advance every observation window involving ``job``'s node."""
        # check every observation window that involves job's node
        observing = self._obs_by_node.get(job.node_id)
        if not observing:
            return
        for jid in list(observing):
            obs = self._obs.get(jid)
            if obs is not None:
                self._check_observation(sim, sim.jobs[jid], obs)

    def _check_observation(self, sim, job: Job, obs: _Observation) -> None:
        if job.state != JobState.OBSERVING or job.node_id != obs.node_id:
            # the observed placement was torn down under us (node failure /
            # involuntary undo re-queued the job): the window is void
            self._drop_obs(job.id)
            return
        node = sim.nodes[obs.node_id]
        involved = [sim.jobs[i] for i in obs.epochs_at_alloc]
        # "until one epoch has passed for all co-located jobs" (line 12)
        for other in involved:
            if other.state == JobState.DONE:
                continue
            if other.checkpointed_epochs < obs.epochs_at_alloc[other.id] + 1:
                return  # keep observing
        # measured rates: record into H (line 13), re-estimate JCT (line 14)
        live = [o for o in involved if o.state != JobState.DONE]
        profiles = [o.profile for o in live]
        measured_inflation = sim.true_inflation(profiles)
        from repro_torch.cluster import colocation

        self.history.record(colocation.set_signature(profiles), measured_inflation)
        ok = True
        for o in live:
            exclusive_finish = sim.now + o.remaining_epochs * o.profile.epoch_hours
            if exclusive_finish > o.deadline:
                continue  # hopeless SLO either way: undoing cannot help
            # width-aware: a narrowed elastic job runs off its allocated
            # width, not the reference (identical for rigid jobs)
            excl_h = scaling.epoch_hours_at(
                o.profile, len(o.gpu_ids) or o.profile.n_gpus
            )
            epoch_h = excl_h * measured_inflation * node.time_factor(o.profile)
            if sim.now + o.remaining_epochs * epoch_h > o.deadline:
                ok = False
                break
        self._drop_obs(job.id)
        if ok:
            job.state = JobState.RUNNING  # finalize (line 16)
        else:
            # undo at the epoch boundary (lines 18-19): progress stays at the
            # last checkpoint; the failed set is excluded and j retries
            job.undo_count += 1
            obs.failed_sets.add((obs.node_id, obs.gpu_ids))
            sim.deallocate(job, to_queue=True, checkpoint=True)

    def on_complete(self, sim, job: Job) -> None:
        """Forget the finished job's observation/exclusion bookkeeping."""
        self._drop_obs(job.id)
        self._failed.pop(job.id, None)

    def on_node_freed(self, sim, node: Node) -> None:
        """No-op: the sleep pass runs at the end of try_schedule."""

    def _sleep_idle(self, sim) -> None:
        if not self.sleeps_idle_nodes:
            return
        fleet = getattr(sim, "fleet", None)
        if fleet is not None:
            # the ON-and-idle set, directly; sorted() both restores the old
            # full-scan visit order (ascending id) and copies the set before
            # the state writes mutate it
            for nid in sorted(fleet.on_idle):
                node = sim.nodes[nid]
                node.account_energy(sim.now, sim.jobs, sim.power)
                node.state = NodeState.SLEEP
            return
        for node in sim.nodes:
            if node.state == NodeState.ON and node.is_idle():
                node.account_energy(sim.now, sim.jobs, sim.power)
                node.state = NodeState.SLEEP


class EaCOOcc(EaCO):
    """Beyond-paper variant (§4.2's suggestion): occupancy-style headroom.

    Uses the duty-cycle headroom rather than the conservative utilization
    threshold — admits deeper co-location (degree 6, 95% threshold) and
    ranks candidates by predicted marginal cost (Eq. 1) instead of raw
    utilization.
    """

    name = "eaco-occ"

    def __init__(self, history: Optional[History] = None, alpha: float = 0.5):
        super().__init__(
            thresholds=Thresholds(util=95.0, mem=90.0, max_residents=6),
            history=history,
            alpha=alpha,
        )

    def _rank(self, candidates: List[Candidate]) -> List[Candidate]:
        # deeper packing first, then hottest, then least host-
        # oversubscribed (constant 0.0 when host-blind), then perf/watt
        return sorted(
            candidates,
            key=lambda c: (-c.degree, -c.utilization, c.host_over, -c.perf_per_watt),
        )
