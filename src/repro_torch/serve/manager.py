"""The serving manager: replicas, request routing, and the autoscaler.

Replicas are *pseudo-jobs*: each one is a width-1 ``Job`` with an
infinite deadline and a ``serve:<family>`` profile, placed through the
simulator's normal ``allocate`` path — so co-location inflation pricing,
HBM gating, per-job energy attribution and telemetry all apply to serving
for free, and training jobs sharing a GPU with a replica are slowed by
exactly the calibrated co-location model.  The simulator never *rates*
replicas (they carry no epochs); their work is the request stream.

Attachment mirrors the telemetry hub: ``ServeManager(cfg).attach(sim)``
sets ``sim.serve`` only when the config is enabled, so a disabled manager
is indistinguishable from an absent one (``sim.serve is None`` either
way) and every simulator metric stays byte-identical — locked by
``tests/test_serve.py``.

Event kinds (handled by the simulator, delegated here):

  ``request_batch``  one arrival burst ``(family, n)`` — routed to the
                     least-backlogged active replica of the family, its
                     latency ramp folded analytically (``repro_torch.serve.stats``);
                     pure accounting: never marks the scheduler dirty, so
                     it composes with same-timestamp coalescing.
  ``serve_scale``    the periodic autoscaler tick: provisions
                     ``ceil(rate / (capacity x target_load))`` replicas
                     per family by harvesting co-location headroom
                     (``find_candidates`` + the scheduler's Eq. 2 gate),
                     drains surplus, and evicts under training- or
                     power-cap pressure.  Allocation changes go through
                     ``allocate``/``deallocate``, which mark the scheduler
                     dirty as usual.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster import colocation
from repro_torch.cluster.job import Job, JobState
from repro_torch.cluster.node import NodeState
from repro_torch.control import messages as ctl
from repro_torch.core.candidates import Thresholds, find_candidates
from repro_torch.serve.models import ServeModel
from repro_torch.serve.stats import LatencyHist, ramp_slo_violations

# consecutive failed scale-up attempts (with zero live replicas of the
# family) after which pending traffic is shed instead of retried forever —
# the backstop that keeps a broken fleet from ticking to infinity
_MAX_CONSEC_UP_FAILURES = 50


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving/autoscaler knobs.

    ``enabled=False`` makes :meth:`ServeManager.attach` a no-op (the
    simulator keeps ``sim.serve = None``), the same absent==disabled
    contract the telemetry hub follows.
    """

    models: Tuple[ServeModel, ...]
    enabled: bool = True
    scale_period_h: float = 0.1  # autoscaler tick (6 min)
    target_load: float = 0.7  # provision to ~70% of replica capacity
    max_replicas_per_model: int = 32
    # placement thresholds for replica candidates (same Alg. 2 semantics
    # as training placement: utilization/memory/degree caps)
    thresholds: Thresholds = Thresholds()
    # training-pressure eviction: evict one replica per tick while queued
    # training work has waited longer than this
    evict_wait_h: float = 0.5
    # scale-up cooldown after any eviction (multiples of the tick period)
    evict_cooldown_ticks: float = 2.0

    def __post_init__(self):
        if not self.models:
            raise ValueError("ServeConfig needs >= 1 ServeModel")
        if len({m.name for m in self.models}) != len(self.models):
            raise ValueError("duplicate ServeModel names")
        if self.scale_period_h <= 0 or not 0 < self.target_load <= 1:
            raise ValueError("scale_period_h > 0 and target_load in (0, 1]")


class Replica:
    """One placed model instance: the pseudo-job plus its fluid queue
    clock (``free_t_h`` = the absolute hour at which its backlog drains)."""

    __slots__ = ("job", "model", "free_t_h", "served", "draining")

    def __init__(self, job: Job, model: ServeModel, now: float):
        self.job = job
        self.model = model
        self.free_t_h = now
        self.served = 0.0
        self.draining = False

    def backlog_h(self, now: float) -> float:
        """Hours of queued work ahead of a new arrival (>= 0)."""
        return max(self.free_t_h - now, 0.0)


class ServeManager:
    """Serving control plane for one simulator (see module docstring)."""

    def __init__(self, cfg: ServeConfig):
        self.cfg = cfg
        self.by_model: Dict[str, ServeModel] = {m.name: m for m in cfg.models}
        self.replicas: Dict[int, Replica] = {}  # live, by pseudo-job id
        self.model_replicas: Dict[str, List[Replica]] = {
            m.name: [] for m in cfg.models
        }
        self.hist: Dict[str, LatencyHist] = {
            m.name: LatencyHist() for m in cfg.models
        }
        self.slo_violations: Dict[str, float] = {m.name: 0.0 for m in cfg.models}
        # un-routable bursts (no live replica yet), per family
        self._pending: Dict[str, List[Tuple[float, int]]] = {
            m.name: [] for m in cfg.models
        }
        self._pending_n = 0
        self._window_count: Dict[str, int] = {m.name: 0 for m in cfg.models}
        self._seen_traffic: Dict[str, bool] = {m.name: False for m in cfg.models}
        self._consec_up_failures: Dict[str, int] = {m.name: 0 for m in cfg.models}
        self._remaining_batches = 0
        self._last_scale_t = 0.0
        self._no_up_until = -math.inf
        self._cap_infeasible_seen = 0
        self._pressure_since_tick = 0
        self._pressure_carry = False
        self._retired_jobs: List[Job] = []
        self._replica_hours = 0.0
        self._place_t: Dict[int, float] = {}
        # headline counters
        self.requests_total = 0
        self.served_total = 0.0
        self.dropped_requests = 0
        self.scale_up_count = 0
        self.scale_down_count = 0
        self.evict_count = 0
        self.scale_failures = 0
        self.replicas_peak = 0

    # ------------------------------------------------------------ lifecycle

    def attach(self, sim) -> "ServeManager":
        """Install on ``sim`` (``sim.serve``) unless disabled; returns
        ``self`` either way so call sites can chain."""
        if not self.cfg.enabled:
            return self
        if sim.serve is not None:
            raise ValueError("simulator already has a serving manager")
        sim.serve = self
        self._last_scale_t = sim.now
        return self

    def active(self) -> bool:
        """Whether serving work remains: undelivered stream batches, live
        replicas (possibly still draining backlog), or pending traffic —
        the simulator's run loop must not early-exit while this holds."""
        return (
            self._remaining_batches > 0
            or bool(self.replicas)
            or self._pending_n > 0
        )

    # ------------------------------------------------------- event handlers

    def on_request_batch(self, sim, payload: Tuple[str, int]) -> None:
        """Route one arrival burst ``(family, n)`` at ``sim.now``."""
        family, n = payload
        model = self.by_model.get(family)
        if model is None:
            raise ValueError(
                f"request for unknown serve family {family!r}; "
                f"known: {sorted(self.by_model)}"
            )
        self._remaining_batches -= 1
        self._window_count[family] += n
        self.requests_total += n
        reps = [r for r in self.model_replicas[family] if not r.draining]
        if not reps:
            self._pending[family].append((sim.now, n))
            self._pending_n += n
            return
        self._serve_on(sim, min(reps, key=self._route_key), sim.now, n)

    @staticmethod
    def _route_key(r: Replica) -> Tuple[float, int]:
        # least backlog first; job id breaks ties deterministically
        return (r.free_t_h, r.job.id)

    @staticmethod
    def _evict_key(sim, r: Replica) -> Tuple[float, float, int]:
        """Eviction order under pressure: replicas on host-oversubscribed
        nodes first (freeing them relieves the input-pipeline contention
        every training co-resident pays), then least backlog, then job id.
        ``host_over`` mirrors the admission ranker's definition — demand
        beyond one node's supply per host resource — and is a constant
        0.0 on host-blind fleets, so the GPU-only order is untouched
        there."""
        node = sim.nodes[r.job.node_id]
        over = max(
            0.0,
            node.cpu_raw - colocation.HOST_SUPPLY,
            node.dram_raw - colocation.HOST_SUPPLY,
            node.loader_raw - colocation.HOST_SUPPLY,
        )
        return (-over, r.free_t_h, r.job.id)

    def _serve_on(self, sim, rep: Replica, t_arrival: float, n: int) -> None:
        """Fold a burst of ``n`` requests into ``rep``'s fluid queue."""
        node = sim.nodes[rep.job.node_id]
        rate = rep.model.service_rate_rps(n, node.freq)
        if rate <= 0.0 or not math.isfinite(rate):
            # throttled-to-stall replica (deep DVFS floor): it cannot
            # drain a ramp — re-pend the burst for the autoscaler's next
            # tick instead of folding a divide-by-zero into the histogram
            self._pending[rep.model.name].append((t_arrival, n))
            self._pending_n += n
            return
        start = max(t_arrival, rep.free_t_h)
        wait_s = (start - t_arrival) * 3600.0
        span_h = n / rate / 3600.0
        rep.free_t_h = start + span_h
        rep.served += n
        self.served_total += n
        fam = rep.model.name
        self.hist[fam].fold_ramp(wait_s, rate, n)
        self.slo_violations[fam] += ramp_slo_violations(
            wait_s, rate, n, rep.model.slo_s
        )
        if sim.telemetry is not None:
            sim.telemetry.serve_event(
                t_arrival, "batch", fam, node.id, float(n)
            )

    def on_scale(self, sim) -> None:
        """One autoscaler tick: retire drained surplus, evict under
        pressure, resize each family toward its demand, re-arm."""
        now = sim.now
        dt_h = max(now - self._last_scale_t, 1e-9)
        # surplus replicas marked draining earlier whose backlog cleared
        for rep in [r for r in self.replicas.values() if r.draining]:
            if rep.free_t_h <= now:
                self._retire(sim, rep, "drain")
        self._handle_pressure(sim)
        stream_done = self._remaining_batches <= 0
        for fam, model in self.by_model.items():
            if self._window_count[fam]:
                self._seen_traffic[fam] = True
            rate_rps = self._window_count[fam] / dt_h / 3600.0
            desired = (
                math.ceil(rate_rps / (model.capacity_rps * self.cfg.target_load))
                if rate_rps > 0
                else 0
            )
            live = [r for r in self.model_replicas[fam] if not r.draining]
            if self._pending[fam]:
                desired = max(desired, 1)
            if not stream_done:
                # warm floor: a family that has seen traffic keeps one
                # replica until the stream ends — cold starts re-pend
                # whole bursts and dominate p99 otherwise
                if self._seen_traffic[fam]:
                    desired = max(desired, 1)
                # backlog rule: rate-based sizing is blind to queue already
                # built up; add capacity while any live replica's backlog
                # alone would blow the SLO
                if live and max(r.backlog_h(now) for r in live) * 3600.0 > model.slo_s:
                    desired = max(desired, len(live) + 1)
            elif not self._pending[fam]:
                desired = 0
            desired = min(desired, self.cfg.max_replicas_per_model)
            self._resize_family(sim, fam, desired)
            self._window_count[fam] = 0
        self._last_scale_t = now
        if self.active():
            sim.push(now + self.cfg.scale_period_h, "serve_scale", None)

    # ------------------------------------------------------------- scaling

    def _resize_family(self, sim, family: str, desired: int) -> None:
        live = [r for r in self.model_replicas[family] if not r.draining]
        if desired > len(live) and sim.now >= self._no_up_until:
            for _ in range(desired - len(live)):
                if not self._scale_up(sim, family):
                    break
        elif desired < len(live):
            # drain the least-backlogged surplus first (cheapest to stop)
            for rep in sorted(live, key=self._route_key)[: len(live) - desired]:
                rep.draining = True
                self.scale_down_count += 1
                if sim.telemetry is not None:
                    sim.telemetry.serve_event(
                        sim.now, "scale_down", family, rep.job.node_id,
                        float(rep.job.id),
                    )
                if rep.free_t_h <= sim.now:
                    self._retire(sim, rep, "drain")

    def _cand_sort_key(self, sim, cand) -> Tuple[int, float, float, int]:
        """Harvest order: busy ON nodes first (headroom that costs no
        wake), then idle ON, then sleeping; hottest and best perf/watt
        within a class — the same packing instinct as EaCO's ranker."""
        node = sim.nodes[cand.node_id]
        if node.state == NodeState.SLEEP:
            state_rank = 2
        elif cand.resident_ids or not node.is_idle():
            state_rank = 0
        else:
            state_rank = 1
        return (state_rank, -cand.utilization, -cand.perf_per_watt, cand.node_id)

    def _scale_up(self, sim, family: str) -> bool:
        """Place one new replica of ``family``; False when no candidate
        passes the thresholds + deadline gate."""
        model = self.by_model[family]
        probe = Job(
            id=-1, profile=model.profile(), arrival=sim.now, deadline=math.inf
        )
        cands = find_candidates(sim, probe, self.cfg.thresholds)
        predictor = getattr(sim.scheduler, "predictor", None)
        chosen = None
        for cand in sorted(cands, key=lambda c: self._cand_sort_key(sim, c)):
            if predictor is not None and cand.resident_ids:
                residents = [sim.jobs[i] for i in cand.resident_ids]
                widths = {j.id: len(j.gpu_ids) for j in residents if j.gpu_ids}
                if not predictor.deadlines_met(
                    sim.now, [probe, *residents], sim.nodes[cand.node_id],
                    widths=widths or None,
                ):
                    continue
            chosen = cand
            break
        if chosen is None:
            self.scale_failures += 1
            fails = self._consec_up_failures[family] + 1
            self._consec_up_failures[family] = fails
            if fails >= _MAX_CONSEC_UP_FAILURES and not any(
                not r.draining for r in self.model_replicas[family]
            ):
                self._shed_pending(sim, family)
            return False
        self._consec_up_failures[family] = 0
        job = sim.register_serve_job(model.profile())
        sim.control.submit(
            ctl.ScalePlan(
                "serve", (ctl.place(job.id, chosen.node_id, chosen.gpu_ids),)
            )
        )
        rep = Replica(job, model, sim.now)
        self.replicas[job.id] = rep
        self.model_replicas[family].append(rep)
        self._place_t[job.id] = sim.now
        self.scale_up_count += 1
        self.replicas_peak = max(self.replicas_peak, len(self.replicas))
        if sim.telemetry is not None:
            sim.telemetry.serve_event(
                sim.now, "scale_up", family, chosen.node_id, float(job.id)
            )
        self._drain_pending(sim, family)
        return True

    def _drain_pending(self, sim, family: str) -> None:
        pending, self._pending[family] = self._pending[family], []
        for t0, n in pending:
            self._pending_n -= n
            reps = [r for r in self.model_replicas[family] if not r.draining]
            self._serve_on(sim, min(reps, key=self._route_key), t0, n)

    def _shed_pending(self, sim, family: str) -> None:
        """Drop undeliverable pending traffic (all of it SLO-violating) so
        a fleet with no placeable capacity cannot tick forever."""
        pending, self._pending[family] = self._pending[family], []
        shed = sum(n for _, n in pending)
        if not shed:
            return
        self._pending_n -= shed
        self.dropped_requests += shed
        self.slo_violations[family] += shed
        if sim.telemetry is not None:
            sim.telemetry.serve_event(sim.now, "drop", family, -1, float(shed))

    def _retire(self, sim, rep: Replica, reason: str) -> None:
        """Tear one replica down: deallocate the pseudo-job (freeing the
        GPU and re-rating co-residents) and mark it done."""
        job = rep.job
        fam = rep.model.name
        if sim.telemetry is not None:
            sim.telemetry.serve_event(
                sim.now, reason, fam, job.node_id, float(job.id)
            )
        sim.control.submit(
            ctl.ScalePlan(
                "serve",
                (ctl.evict(job.id, to_queue=False, checkpoint=False,
                           reason=reason),),
            )
        )
        sim.retire_serve_job(job)
        self._replica_hours += sim.now - self._place_t.pop(job.id, sim.now)
        self._retired_jobs.append(job)
        del self.replicas[job.id]
        self.model_replicas[fam].remove(rep)

    # ------------------------------------------------------------ pressure

    def on_training_pressure(self, sim, n_unplaced: int) -> None:
        """Scheduler signal: ``n_unplaced`` queued training jobs found no
        admissible candidate this pass.  Recorded only — eviction happens
        at the next tick, where the freed capacity is re-scheduled inside
        a normal event step."""
        self._pressure_since_tick += n_unplaced

    def _oldest_wait_h(self, sim) -> float:
        for jid in sim.queue.first_n(1):
            job = sim.jobs[jid]
            if job.state == JobState.QUEUED:
                return sim.now - job.arrival
        return 0.0

    def _handle_pressure(self, sim) -> None:
        """Evict (at most one replica per tick) when training starves or
        the power-cap enforcer hit its ladder floor since the last tick."""
        cap = sim.power_cap
        cap_pressed = (
            cap is not None and cap.infeasible_events > self._cap_infeasible_seen
        )
        if cap is not None:
            self._cap_infeasible_seen = cap.infeasible_events
        if self._pressure_since_tick:
            # sticky: the scheduler only re-signals when some event re-runs
            # try_schedule, which may never happen while the fleet is wedged
            # — carry the signal until the queue head actually drains
            self._pressure_carry = True
            self._pressure_since_tick = 0
        wait_h = self._oldest_wait_h(sim)
        if wait_h <= 0.0:
            self._pressure_carry = False
        train_pressed = self._pressure_carry and wait_h > self.cfg.evict_wait_h
        if not (cap_pressed or train_pressed) or not self.replicas:
            return
        # host-saturated hosts first, then the least-backlogged replica
        # (the cheapest to give back)
        victim = min(
            self.replicas.values(), key=lambda r: self._evict_key(sim, r)
        )
        self.evict_count += 1
        self._retire(sim, victim, "evict")
        self._no_up_until = (
            sim.now + self.cfg.evict_cooldown_ticks * self.cfg.scale_period_h
        )

    def on_replica_failure(self, sim, job: Job) -> None:
        """Node-failure path: the replica dies with its node (its queued
        work re-pends; the autoscaler re-provisions on the next tick)."""
        rep = self.replicas[job.id]
        self._retire(sim, rep, "failure")

    # ---------------------------------------------------- DVFS integration

    def replica_slack_h(self, sim, jid: int) -> float:
        """SLO slack of replica ``jid`` in hours, for the power-cap
        enforcer's ordering: seconds of extra latency it could absorb
        before violating its SLO (negative once the backlog alone exceeds
        the SLO — such nodes are raised first and throttled last)."""
        rep = self.replicas[jid]
        est_s = rep.backlog_h(sim.now) * 3600.0 + rep.model.latency_s(
            rep.model.max_batch
        )
        return (rep.model.slo_s - est_s) / 3600.0

    # ------------------------------------------------------------- results

    def summary(self) -> Dict[str, Any]:
        """The ``results()["serve"]`` payload: fleet-wide and per-family
        request counts, latency quantiles, SLO violations, energy and
        autoscaler activity."""
        overall = LatencyHist()
        per_model: Dict[str, Any] = {}
        for fam in sorted(self.by_model):
            h = self.hist[fam]
            overall.merge(h)
            per_model[fam] = {
                **h.summary(),
                "slo_s": self.by_model[fam].slo_s,
                "slo_violations": self.slo_violations[fam],
                "replicas": sum(
                    1 for r in self.model_replicas[fam] if not r.draining
                ),
            }
        energy = sum(j.energy_kwh for j in self._retired_jobs)
        energy += sum(r.job.energy_kwh for r in self.replicas.values())
        live_hours = self._replica_hours
        return {
            "requests_total": self.requests_total,
            "served_total": self.served_total,
            "dropped_requests": self.dropped_requests,
            "pending_requests": self._pending_n,
            "slo_violations": sum(self.slo_violations.values()),
            "p50_ms": overall.quantile(0.50) * 1e3,
            "p99_ms": overall.quantile(0.99) * 1e3,
            "mean_ms": overall.mean_s * 1e3,
            "serve_energy_kwh": energy,
            "replicas_live": len(self.replicas),
            "replicas_peak": self.replicas_peak,
            "replica_hours": live_hours,
            "scale_up_count": self.scale_up_count,
            "scale_down_count": self.scale_down_count,
            "evict_count": self.evict_count,
            "scale_failures": self.scale_failures,
            "per_model": per_model,
        }


def load_request_stream(
    sim, stream: Sequence[Tuple[str, float, int]]
) -> None:
    """Feed a ``generate_request_stream`` result (or CSV load) into an
    attached, enabled serving manager: one ``request_batch`` event per
    burst plus the ``serve_scale`` tick chain, armed at the first arrival.
    Raises when no manager is attached — silently dropping a stream would
    masquerade as a perfect-latency replay."""
    if sim.serve is None:
        raise ValueError(
            "attach an enabled ServeManager before loading a request stream"
        )
    if not stream:
        return
    for family, t, n in stream:
        sim.push(t, "request_batch", (family, int(n)))
    sim.serve._remaining_batches += len(stream)
    sim.push(stream[0][1], "serve_scale", None)
