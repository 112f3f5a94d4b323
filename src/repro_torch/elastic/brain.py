"""Energy-driven resize-plan optimizer (the autoscaler "Brain").

Mirrors the resource-plan "Brain" architecture of elastic trainers
(EasyDL/dlrover): given a cluster snapshot, propose grow / shrink /
migrate plans for running jobs, each scored with the calibrated
``PowerModel`` (predicted energy delta over the affected jobs' remaining
lifetimes) and the ``JCTPredictor`` (runtime delta and deadline risk).
The Brain only *proposes*; the ``ElasticController`` applies accepted
plans through ``Simulator.request_resize``, which lands them on epoch
boundaries so the existing checkpoint semantics hold.

Plan kinds:

  * **migrate** — move a job (any job, rigid included: migration does not
    change its width) onto another awake node, either onto free GPUs
    (inflation-free) or co-located with that node's residents under the
    predictor's inflation estimate.  Emptying the source node lets the
    scheduler's sleep pass park it — the consolidate-and-sleep payoff the
    paper attributes EaCO's savings to, extended from admission time to
    the whole job lifetime;
  * **grow** — widen an elastic job into free GPUs on its own node when
    the queue is empty and the predicted JCT gain is not bought with an
    energy regression;
  * **shrink** — halve an elastic no-SLO job under queue pressure so a
    waiting job can backfill the freed GPUs.  Credited only when a
    sleeping node would otherwise have to be woken — in a saturated
    cluster the credit is zero and shrinks never win (shrinking
    lengthens runtime, which costs more energy than packing saves).

Scoring model (affected nodes only, horizon H = max of the before/after
remaining times): a node draws ``P(sum_j u_j * w_j / n_gpus)`` from the
concave calibrated fit, ``idle_w`` when empty and awake, and ``sleep_w``
once the sleep pass can park it.  Co-located placements add the extra
node-hot-hours caused by inflating the target's residents.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

from repro_torch.cluster.job import Job, JobState
from repro_torch.cluster.node import Node, NodeState
from repro_torch.core.predictor import JCTPredictor
from repro_torch.elastic import scaling


@dataclasses.dataclass(frozen=True)
class Plan:
    kind: str  # "grow" | "shrink" | "migrate"
    job_id: int
    node_id: int  # target node (== current node for grow/shrink)
    width: int  # target GPU count
    energy_delta_kwh: float  # predicted; negative = saves energy
    jct_delta_h: float  # predicted runtime change of the job; negative = faster
    # the co-residents this plan was scored (and deadline-checked) against;
    # the resize event aborts if the set changed by the time it fires
    co_resident_ids: Tuple[int, ...] = ()


@dataclasses.dataclass
class BrainConfig:
    # ignore migrations whose predicted saving is below this (model noise)
    min_saving_kwh: float = 0.5
    # grow plans may cost up to this much energy when they buy JCT
    grow_tolerance_kwh: float = 0.0
    # only propose shrinks when at least this many jobs are queued
    shrink_queue_depth: int = 4
    # never resize a single job more than this many times (anti-thrash)
    max_resizes_per_job: int = 16
    # cap on plans returned per proposal round
    max_plans: int = 8
    # the scheduler parks empty nodes in the low-power state
    sleeps_idle_nodes: bool = True


class Brain:
    """The resize-plan optimizer (see the module docstring for the plan
    kinds and scoring model).  Proposes; never mutates the simulator."""

    def __init__(self, predictor: JCTPredictor, cfg: Optional[BrainConfig] = None):
        self.predictor = predictor
        self.cfg = cfg or BrainConfig()

    # ------------------------------------------------------------- helpers

    def _power(self, sim, node: Node, util: float) -> float:
        """``node``'s draw at ``util`` under its own SKU power model and
        current DVFS step; an empty node sleeps (or idles) instead."""
        pm = node.power_model(sim.power)
        if util <= 1e-9:
            return pm.sleep_w if self.cfg.sleeps_idle_nodes else pm.idle_w
        return pm.node_power_at(min(util, 100.0), node.freq)

    @staticmethod
    def _node_util(sim, node: Node, exclude: Optional[int] = None) -> float:
        u = 0.0
        for jid in node.resident_job_ids():
            if jid == exclude:
                continue
            j = sim.jobs[jid]
            u += j.profile.gpu_util * len(j.gpu_ids) / node.n_gpus
        return min(u, 100.0)

    @staticmethod
    def _free_gpus(node: Node, job: Job) -> List[int]:
        """GPUs with no residents other than (possibly) ``job`` itself."""
        out = []
        for g in range(node.n_gpus):
            if all(i == job.id for i in node.gpu_residents[g]):
                out.append(g)
        return out

    def _remaining_hours(self, sim, job: Job, width: int, infl: float,
                         time_factor: float) -> float:
        epoch_h = scaling.epoch_hours_at(job.profile, width) * infl * time_factor
        return job.remaining_epochs * epoch_h

    def _inflation_at(self, sim, job: Job) -> float:
        node = sim.nodes[job.node_id]
        co = [sim.jobs[i].profile for i in node.residents_on(job.gpu_ids)]
        return self.predictor.predict_inflation(co)

    # ------------------------------------------------------------- scoring

    def _score_move(
        self,
        sim,
        job: Job,
        target: Node,
        width: int,
        co_residents: Tuple[Job, ...] = (),
        src_inflation: Optional[float] = None,
    ) -> Plan:
        """Predicted (energy, jct) delta of running ``job`` at ``width`` on
        ``target`` versus leaving it in place.  ``co_residents``: target
        jobs that would share GPUs with it (empty = free placement).
        ``src_inflation``: precomputed current inflation (it is invariant
        across candidate targets — callers scoring many targets hoist it)."""
        src = sim.nodes[job.node_id]
        w0 = len(job.gpu_ids)
        contrib0 = job.profile.gpu_util * w0 / src.n_gpus
        contrib1 = job.profile.gpu_util * width / target.n_gpus
        infl0 = (
            src_inflation
            if src_inflation is not None
            else self._inflation_at(sim, job)
        )
        if target.id == src.id:
            # same-node grow/shrink keeps the current co-residents (the GPU
            # picker prefers held GPUs), so the inflation term is unchanged —
            # scoring it at 1.0 would credit the width change with a
            # co-location escape that never happens
            infl1 = infl0
        else:
            infl1 = self.predictor.predict_inflation(
                [job.profile, *(r.profile for r in co_residents)]
            )
        t0 = self._remaining_hours(sim, job, w0, infl0, src.time_factor(job.profile))
        t1 = self._remaining_hours(
            sim, job, width, infl1, target.time_factor(job.profile)
        )
        h = max(t0, t1)
        u_src_wo = self._node_util(sim, src, exclude=job.id)
        if target.id == src.id:
            u_with0 = u_src_wo + contrib0
            u_with1 = u_src_wo + contrib1
            e0 = self._power(sim, src, u_with0) * t0 + self._power(
                sim, src, u_src_wo
            ) * (h - t0)
            e1 = self._power(sim, src, u_with1) * t1 + self._power(
                sim, src, u_src_wo
            ) * (h - t1)
            kind = "grow" if width > w0 else "shrink"
        else:
            u_tgt_wo = self._node_util(sim, target)
            p_src_on = self._power(sim, src, u_src_wo + contrib0)
            p_src_off = self._power(sim, src, u_src_wo)
            p_tgt_on = self._power(sim, target, u_tgt_wo + contrib1)
            p_tgt_off = self._power(sim, target, u_tgt_wo)
            e0 = (p_src_on + p_tgt_off) * t0 + (p_src_off + p_tgt_off) * (h - t0)
            e1 = (p_src_off + p_tgt_on) * t1 + (p_src_off + p_tgt_off) * (h - t1)
            # co-location inflates the target's residents: the node stays
            # hot for the extra hours they now need (migrate targets only)
            for r in co_residents:
                infl_r0 = self._inflation_at(sim, r)
                infl_r1 = self.predictor.predict_inflation(
                    [
                        r.profile,
                        job.profile,
                        *(
                            sim.jobs[i].profile
                            for i in target.residents_on(r.gpu_ids)
                            if i != r.id
                        ),
                    ]
                )
                wr = len(r.gpu_ids)
                tf_r = target.time_factor(r.profile)
                dt_r = self._remaining_hours(
                    sim, r, wr, infl_r1, tf_r
                ) - self._remaining_hours(sim, r, wr, infl_r0, tf_r)
                e1 += max(dt_r, 0.0) * p_tgt_on
            kind = "migrate"
        return Plan(
            kind=kind,
            job_id=job.id,
            node_id=target.id,
            width=width,
            energy_delta_kwh=(e1 - e0) / 1000.0,
            jct_delta_h=t1 - t0,
            co_resident_ids=tuple(r.id for r in co_residents),
        )

    def _deadlines_safe(self, sim, job: Job, target: Node, width: int,
                        co_residents: Tuple[Job, ...]) -> bool:
        """The moved job and every impacted target resident keep their
        deadlines under the predicted post-move inflation.

        Each resident ``r`` is checked against its *full* post-move co-set
        (the job plus any third parties already sharing r's GPUs), matching
        the inflation the energy model charges in ``_score_move``.  Like
        ``deadlines_met``, a job whose SLO is hopeless even at the
        reference-width exclusive rate is admitted best-effort.
        """
        pred = self.predictor
        if math.isfinite(job.deadline):
            excl = sim.now + job.remaining_epochs * job.profile.epoch_hours
            fin = pred.predict_finish(
                sim.now,
                job,
                [job.profile, *(r.profile for r in co_residents)],
                target.time_factor(job.profile),
                width,
            )
            # hopeless SLOs are best-effort (mirrors deadlines_met): an
            # already-overdue job must stay movable or it pins its node awake
            if excl <= job.deadline and fin > job.deadline:
                return False
        for r in co_residents:
            if not math.isfinite(r.deadline):
                continue
            excl = sim.now + r.remaining_epochs * r.profile.epoch_hours
            if excl > r.deadline:
                continue  # hopeless SLO either way (best-effort)
            others = [
                sim.jobs[i].profile
                for i in target.residents_on(r.gpu_ids)
                if i != r.id
            ]
            profiles = [r.profile, job.profile, *others]
            fin_r = pred.predict_finish(
                sim.now, r, profiles, target.time_factor(r.profile), len(r.gpu_ids)
            )
            if fin_r > r.deadline:
                return False
        return True

    # ------------------------------------------------------------ proposal

    def _movable(self, sim, job: Job) -> bool:
        return (
            job.state == JobState.RUNNING  # never move OBSERVING jobs
            and job.node_id is not None
            and job.resize_count < self.cfg.max_resizes_per_job
            and job.remaining_epochs > 1.0  # a resize lands one epoch out
        )

    def _migration_plans(self, sim, job: Job) -> List[Plan]:
        src = sim.nodes[job.node_id]
        w0 = len(job.gpu_ids)
        infl0 = self._inflation_at(sim, job)  # invariant across targets
        out: List[Plan] = []
        for tgt in sim.nodes:
            if tgt.id == src.id or tgt.state != NodeState.ON:
                continue
            gpus = sim.pick_gpus(tgt, w0, job, prefer_current=False)
            if gpus is None:
                continue
            co = tuple(
                sim.jobs[i]
                for i in sorted(tgt.residents_on(gpus))
                if sim.jobs[i].state != JobState.DONE
            )
            if any(r.state == JobState.OBSERVING for r in co):
                continue  # never perturb an observation window
            if not self._deadlines_safe(sim, job, tgt, w0, co):
                continue
            plan = self._score_move(sim, job, tgt, w0, co, src_inflation=infl0)
            if plan.energy_delta_kwh < -self.cfg.min_saving_kwh:
                out.append(plan)
        return out

    def propose(self, sim) -> List[Plan]:
        """One proposal round: the best grow/migrate/shrink plan per
        resident job, deadline-checked, ranked by predicted saving."""
        cfg = self.cfg
        plans: List[Plan] = []
        queue_depth = len(sim.queue)
        any_sleeping = any(n.state == NodeState.SLEEP for n in sim.nodes)
        # O(active): enumerate resident jobs via node residency instead of
        # scanning the full (mostly DONE) job table at 10k-job scale
        resident_ids = sorted(
            {jid for n in sim.nodes for jid in n.resident_job_ids()}
        )
        for jid in resident_ids:
            job = sim.jobs[jid]
            if not self._movable(sim, job):
                continue
            src = sim.nodes[job.node_id]
            w0 = len(job.gpu_ids)
            elastic = job.profile.is_elastic
            best: Optional[Plan] = None
            # grow into idle capacity on the own node (the queue gets first
            # call on capacity: only when nothing is waiting)
            co_now = tuple(
                sim.jobs[i]
                for i in sorted(src.residents_on(job.gpu_ids))
                if i != job.id
            )
            if elastic and queue_depth == 0 and w0 < job.profile.max_width:
                free = [g for g in self._free_gpus(src, job) if g not in job.gpu_ids]
                w1 = min(job.profile.max_width, w0 + len(free))
                if w1 > w0 and self._deadlines_safe(sim, job, src, w1, co_now):
                    p = self._score_move(sim, job, src, w1, co_now)
                    if p.energy_delta_kwh <= cfg.grow_tolerance_kwh and p.jct_delta_h < 0:
                        best = p
            # migrate to consolidate (and let the source node sleep)
            for p in self._migration_plans(sim, job):
                if best is None or p.energy_delta_kwh < best.energy_delta_kwh:
                    best = p
            # shrink under queue pressure, credited with the sleeping node
            # the backfill avoids waking (zero credit when nothing sleeps)
            if (
                best is None
                and elastic
                and any_sleeping
                and queue_depth >= cfg.shrink_queue_depth
                and w0 > job.profile.min_width
                and not math.isfinite(job.deadline)
            ):
                w1 = max(job.profile.min_width, w0 // 2)
                p = self._score_move(sim, job, src, w1, co_now)
                head = sim.jobs[sim.queue[0]]
                credit = (
                    (sim.power.idle_w - sim.power.sleep_w)
                    * head.profile.base_jct_hours
                    / 1000.0
                )
                scored = dataclasses.replace(
                    p, energy_delta_kwh=p.energy_delta_kwh - credit
                )
                if scored.energy_delta_kwh < -cfg.min_saving_kwh:
                    best = scored
            if best is not None:
                plans.append(best)
        plans.sort(key=lambda p: p.energy_delta_kwh)
        return plans[: cfg.max_plans]
