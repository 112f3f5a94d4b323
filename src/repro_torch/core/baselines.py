"""The paper's three comparison schedulers (§6.2).

``default`` — plain FIFO: strictly arrival-ordered, exclusive full-node
allocation, head-of-line blocking, never sleeps nodes.

``fifo_packed`` — FIFO that packs onto the least-loaded eligible node when
no exclusive node is free (memory-checked), never sleeps nodes.

``gandiva`` — introspective greedy packer modeled after Xiao et al. (OSDI
'18) as the paper evaluates it: prefers exclusive allocation; under
contention packs two jobs by lowest combined utilization; monitors progress
and un-packs when the measured rate degrades past a threshold.  Energy
oblivious (no sleep states).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.cluster import colocation
from repro_torch.cluster.job import Job, JobState
from repro_torch.cluster.node import Node, NodeState
from repro_torch.control import messages as ctl


class _Base:
    sleeps_idle_nodes = False

    def on_arrival(self, sim, job: Job) -> None:
        pass

    def on_epoch(self, sim, job: Job) -> None:
        pass

    def on_complete(self, sim, job: Job) -> None:
        pass

    def on_node_freed(self, sim, node: Node) -> None:
        pass

    def _free_node(self, sim, job: Optional[Job] = None) -> Optional[Node]:
        """First free node on a homogeneous fleet; on a heterogeneous one,
        the free node where ``job`` runs fastest (the paper's baselines are
        energy-oblivious — they chase JCT, not perf/watt, which is exactly
        why they leave the hetero savings on the table)."""
        fleet = getattr(sim, "fleet", None)
        if fleet is not None:
            free = sorted(fleet.on_idle)  # == the full scan's visit order
        else:
            free = [
                n.id
                for n in sim.nodes
                if n.state == NodeState.ON and n.is_idle()
            ]
        best: Optional[Node] = None
        best_speed = 0.0
        for nid in free:
            node = sim.nodes[nid]
            speed = node.job_speed(job.profile) if job else node.speed
            if speed > best_speed:  # strict: ties keep the first (seed order)
                best, best_speed = node, speed
        return best

    def _alloc_whole_node(self, sim, job: Job, node: Node) -> None:
        gpu_ids = tuple(range(job.profile.n_gpus))
        tel = sim.telemetry
        if tel is not None and tel.audit is not None:
            # the baselines place as if sharing were free: audit their
            # implicit prediction (inflation 1.0) against the ground truth,
            # so the drift report quantifies the reality they ignore
            residents = [sim.jobs[i] for i in node.residents_on(gpu_ids)]
            profiles = [job.profile, *(r.profile for r in residents)]
            realized = sim.true_inflation(profiles)
            finish = sim.now + job.remaining_epochs * (
                job.profile.epoch_hours * node.time_factor(job.profile)
            )
            tel.audit.decision(
                sim.now, self.name, job, node.sku_name, node.id,
                len(gpu_ids), len(residents), 0, node.freq,
                1.0, realized, finish,
            )
        sim.control.submit(
            ctl.ScalePlan(self.name, (ctl.place(job.id, node.id, gpu_ids),))
        )


class FIFO(_Base):
    """The paper's ``default``: exclusive, arrival order, blocking."""

    name = "fifo"

    def try_schedule(self, sim) -> None:
        """Allocate the head job to a free node, or block on it."""
        while sim.queue:
            job = sim.jobs[sim.queue[0]]
            node = self._free_node(sim, job)
            if node is None:
                return  # head-of-line blocks
            self._alloc_whole_node(sim, job, node)


class FIFOPacked(_Base):
    """FIFO + packing when there is no free node."""

    name = "fifo_packed"
    max_residents = 4
    mem_threshold = 90.0

    def try_schedule(self, sim) -> None:
        """FIFO with packing: free node first, else the least-loaded
        memory-feasible node (fastest SKU on ties)."""
        progressed = True
        while progressed and sim.queue:
            progressed = False
            job = sim.jobs[sim.queue[0]]
            node = self._free_node(sim, job)
            if node is not None:
                self._alloc_whole_node(sim, job, node)
                progressed = True
                continue
            # pack onto the least-loaded node that fits; among equally
            # loaded nodes take the one where the job runs fastest
            best, best_key = None, None
            for node in sim.nodes:
                if node.state != NodeState.ON:
                    continue
                residents = node.resident_job_ids()
                if len(residents) >= self.max_residents:
                    continue
                profs = [sim.jobs[i].profile for i in residents] + [job.profile]
                if colocation.combined_peak_mem(profs) > self.mem_threshold:
                    continue
                key = (node.node_util(sim.jobs), -node.job_speed(job.profile))
                if best is None or key < best_key:
                    best, best_key = node, key
            if best is not None:
                self._alloc_whole_node(sim, job, best)
                progressed = True


class Gandiva(_Base):
    """Introspective packing (profile-driven, energy-oblivious)."""

    name = "gandiva"
    max_residents = 2
    util_budget = 100.0
    mem_threshold = 90.0
    unpack_rate_threshold = 0.70  # un-pack if measured rate < 70% exclusive

    def __init__(self):
        self._packed: Dict[int, float] = {}  # job id -> rate when packed

    def try_schedule(self, sim) -> None:
        """Exclusive first; under contention pack two jobs by lowest
        combined utilization (fastest SKU on ties)."""
        # single forward pass: packing only consumes capacity, so a job
        # that failed earlier in the pass cannot succeed on a re-scan
        for jid in list(sim.queue):
            job = sim.jobs[jid]
            if job.state != JobState.QUEUED:
                continue
            node = self._free_node(sim, job)
            if node is not None:
                self._alloc_whole_node(sim, job, node)
                continue
            best, best_key = None, None
            for n in sim.nodes:
                if n.state != NodeState.ON:
                    continue
                residents = n.resident_job_ids()
                if not residents or len(residents) >= self.max_residents:
                    continue
                profs = [sim.jobs[i].profile for i in residents] + [job.profile]
                u = sum(p.gpu_util for p in profs)
                if u > self.util_budget:
                    continue
                if colocation.combined_peak_mem(profs) > self.mem_threshold:
                    continue
                key = (u, -n.job_speed(job.profile))
                if best is None or key < best_key:
                    best, best_key = n, key
            if best is not None:
                self._alloc_whole_node(sim, job, best)
                self._packed[job.id] = 0.0

    def on_epoch(self, sim, job: Job) -> None:
        """Introspection: un-pack a job whose measured progress rate
        degraded below ``unpack_rate_threshold`` of exclusive."""
        # introspection: un-pack a job whose measured progress rate degraded
        if job.id not in self._packed or job.node_id is None:
            return
        node = sim.nodes[job.node_id]
        residents = node.resident_job_ids()
        if len(residents) <= 1:
            return
        profs = [sim.jobs[i].profile for i in residents]
        measured = sim.true_inflation(profs)
        if 1.0 / measured < self.unpack_rate_threshold:
            job.undo_count += 1
            sim.deallocate(job, to_queue=True, checkpoint=True)


ALL_SCHEDULERS = {
    "fifo": FIFO,
    "fifo_packed": FIFOPacked,
    "gandiva": Gandiva,
}
