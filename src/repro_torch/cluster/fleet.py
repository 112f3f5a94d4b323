"""Struct-of-arrays fleet state: columnar mirrors of per-node scalars.

The simulator's hot loops used to rescan ``sim.nodes`` — a Python list of
objects — on every event: fleet power summed 96 ``current_power_w`` calls,
``FindCandidates`` walked every node, the sleep pass and the power-cap
enforcer filtered the whole fleet by state.  At 10k-job scale those scans
were ~80% of the replay wall clock (see ``docs/performance.md``).

``FleetState`` keeps the per-node scalar state the loops actually consume
in node-id-indexed *columns* plus incrementally-maintained index sets, so
each hot query is O(changed) or O(answer) instead of O(fleet):

  * ``power`` — cached instantaneous draw (W) per node, refreshed lazily
    from ``power_dirty`` so ``Simulator.fleet_power_w`` is a plain sum in
    node-id order (bit-identical to the per-node scan it replaced);
  * ``freq`` / ``state_code`` — NumPy columns for vectorized consumers
    (power settlement, matrices for the differential tests);
  * ``on_idle`` / ``on_busy`` / ``sleep_idle`` / ``sleep_busy`` — state x
    idleness index sets (the sleep pass, the cap enforcer's steppable
    scan, and the baselines' free-node probe read these);
  * per-(SKU, gpu-count) min-heaps over *default* idle nodes (full clock,
    no straggler slowdown) — ``FindCandidates`` asks for the lowest-id
    idle node of each equivalence class instead of enumerating every idle
    node (``odd_idle`` holds the rare throttled/degraded exceptions,
    which are enumerated individually);
  * a per-node eligible-GPU cache for Algorithm 2, invalidated on
    residency changes, with an O(1) eligible-count prefilter.

``Node`` mutators call the ``on_*`` hooks below; everything else reads.
Heavy (N, G) matrices are rebuilt lazily per residency version rather
than maintained per-placement — NumPy scalar writes cost more than the
rebuild amortizes to at fleet sizes the simulator runs.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

# state codes for the columnar mirror (np.int8): ON/SLEEP/FAILED
CODE_ON, CODE_SLEEP, CODE_FAILED = 0, 1, 2
_STATE_TO_CODE = {"on": CODE_ON, "sleep": CODE_SLEEP, "failed": CODE_FAILED}


class FleetState:
    """Columnar + indexed mirror of one simulator's node fleet (see the
    module docstring for the columns and who consumes them)."""

    __slots__ = (
        "nodes",
        "n_nodes",
        "power",
        "power_dirty",
        "freq",
        "state_code",
        "host_cpu",
        "host_dram",
        "host_loader",
        "on_idle",
        "on_busy",
        "sleep_idle",
        "sleep_busy",
        "idle_heap",
        "idle_member",
        "odd_idle",
        "elig_thr",
        "elig",
        "parts",
        "speed_ppw",
        "tf_memo",
        "res_version",
        "_busy_sorted",
        "_matrix_version",
        "_matrices",
    )

    def __init__(self, nodes):
        self.nodes = list(nodes)
        n = len(self.nodes)
        self.n_nodes = n
        # cached instantaneous draw (W), node-id indexed; lazily refreshed
        self.power: List[float] = [0.0] * n
        self.power_dirty: Set[int] = set(range(n))
        # numpy columns
        self.freq = np.ones(n, dtype=np.float64)
        self.state_code = np.zeros(n, dtype=np.int8)
        # host-resource columns: per-node combined resident demand (percent
        # of supply), mirroring Node.cpu_raw / dram_raw / loader_raw — kept
        # in sync by on_residency like the GPU composites
        self.host_cpu = np.zeros(n, dtype=np.float64)
        self.host_dram = np.zeros(n, dtype=np.float64)
        self.host_loader = np.zeros(n, dtype=np.float64)
        # state x idleness index sets
        self.on_idle: Set[int] = set()
        self.on_busy: Set[int] = set()
        self.sleep_idle: Set[int] = set()
        self.sleep_busy: Set[int] = set()
        # per-class idle min-heaps (lazy deletion) + memberships; class key
        # = (sku name or None, n_gpus) — every candidate-relevant quantity
        # of a default idle node is a function of that key alone
        self.idle_heap: Dict[Tuple[Optional[str], int], List[int]] = {}
        self.idle_member: Dict[Tuple[Optional[str], int], Set[int]] = {}
        self.odd_idle: Set[int] = set()  # idle but freq < 1 or slowdown != 1
        # Algorithm-2 eligible-GPU cache: sorted (util, avail_mem, gpu)
        # triples per node, valid for one Thresholds key at a time
        self.elig_thr: Optional[Tuple[float, float, int]] = None
        self.elig: List[Optional[list]] = [None] * n
        # derived candidate parts per node ({width -> tuple of parts}),
        # invalidated with ``elig`` — see ``cand_parts``
        self.parts: List[Optional[dict]] = [None] * n
        # (sku, freq, family sku-speed table, family gpu_util) ->
        # (speed, perf_per_watt): the SKU terms of a Candidate are a pure
        # function of that key, so they are computed once per
        # (family x SKU x frequency) instead of once per candidate
        self.speed_ppw: Dict[tuple, Tuple[float, float]] = {}
        # (slowdown, sku, freq, family sku-speed table, family gpu_util) ->
        # time factor: same collapse for the re-rating hot path
        self.tf_memo: Dict[tuple, float] = {}
        self.res_version = 0
        self._busy_sorted: Optional[List[int]] = None
        self._matrix_version = -1
        self._matrices: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        for node in self.nodes:
            node.fleet = self
            self.freq[node.id] = node.freq
            self._place(node)

    # ------------------------------------------------------------ membership

    @staticmethod
    def _class_key(node) -> Tuple[Optional[str], int]:
        return (node.sku.name if node.sku is not None else None, node.n_gpus)

    def _declassify(self, node) -> None:
        i = node.id
        self.on_idle.discard(i)
        self.on_busy.discard(i)
        self.sleep_idle.discard(i)
        self.sleep_busy.discard(i)
        self.odd_idle.discard(i)
        members = self.idle_member.get(self._class_key(node))
        if members is not None:
            members.discard(i)

    def _place(self, node) -> None:
        i = node.id
        state = node.state
        idle = node.is_idle()
        if state == "failed":
            self.state_code[i] = CODE_FAILED
            return
        if state == "sleep":
            self.state_code[i] = CODE_SLEEP
            (self.sleep_idle if idle else self.sleep_busy).add(i)
        else:
            self.state_code[i] = CODE_ON
            (self.on_idle if idle else self.on_busy).add(i)
        if not idle:
            return
        if node.freq == 1.0 and node.slowdown == 1.0:
            key = self._class_key(node)
            heap = self.idle_heap.get(key)
            if heap is None:
                heap = self.idle_heap[key] = []
                self.idle_member[key] = set()
            members = self.idle_member[key]
            members.add(i)
            heapq.heappush(heap, i)
            if len(heap) > 4 * len(members) + 16:
                # compact the lazy-deletion heap (a sorted list is a heap)
                heap[:] = sorted(members)
        else:
            self.odd_idle.add(i)

    def _reclassify(self, node) -> None:
        self._declassify(node)
        self._place(node)
        self._busy_sorted = None

    # ------------------------------------------------------- mutation hooks

    def on_residency(self, node, idleness_changed: bool) -> None:
        """A job was added to / removed from ``node``."""
        self.res_version += 1
        i = node.id
        self.elig[i] = None
        self.parts[i] = None
        self.power_dirty.add(i)
        self.host_cpu[i] = node.cpu_raw
        self.host_dram[i] = node.dram_raw
        self.host_loader[i] = node.loader_raw
        if idleness_changed:
            self._reclassify(node)

    def on_state(self, node) -> None:
        """``node.state`` changed (wake / sleep / fail / repair)."""
        self.power_dirty.add(node.id)
        self._reclassify(node)

    def on_freq(self, node) -> None:
        """``node.freq`` changed (DVFS step applied)."""
        self.freq[node.id] = node.freq
        self.power_dirty.add(node.id)
        if node.is_idle():
            self._reclassify(node)  # default <-> odd idle class

    def on_slowdown(self, node) -> None:
        """``node.slowdown`` changed (straggler assignment on repair)."""
        if node.is_idle():
            self._reclassify(node)

    def mark_power(self, node_id: int) -> None:
        """Invalidate the cached draw of one node."""
        self.power_dirty.add(node_id)

    # -------------------------------------------------------------- queries

    def busy_ids(self, include_sleeping: bool = True) -> List[int]:
        """Node ids with at least one resident, ascending (cached)."""
        if include_sleeping and self.sleep_busy:  # rare: sleeping-but-busy
            return sorted(self.on_busy | self.sleep_busy)
        ids = self._busy_sorted
        if ids is None:
            ids = self._busy_sorted = sorted(self.on_busy)
        return ids

    def all_idle_ids(self) -> List[int]:
        """Every non-failed idle node id, ascending."""
        if self.sleep_idle:
            return sorted(self.on_idle | self.sleep_idle)
        return sorted(self.on_idle)

    def idle_rep(self, key: Tuple[Optional[str], int]) -> Optional[int]:
        """Lowest idle node id of equivalence class ``key`` (None when the
        class has no idle member) — the candidate the full Algorithm-2
        enumeration would reach first."""
        heap = self.idle_heap.get(key)
        if not heap:
            return None
        members = self.idle_member[key]
        if not members:
            return None
        while heap:
            top = heap[0]
            if top in members:
                return top
            heapq.heappop(heap)  # lazily drop ids that left the class
        return None

    def idle_classes(self) -> List[Tuple[Optional[str], int]]:
        """Known idle equivalence classes, in first-seen (node-id) order."""
        return list(self.idle_heap)

    def ensure_thr(self, thr_key: Tuple[float, float, int]) -> None:
        """Invalidate the eligible/parts caches when the active thresholds
        key changes (they are valid for one key at a time)."""
        if thr_key != self.elig_thr:
            self.elig = [None] * self.n_nodes
            self.parts = [None] * self.n_nodes
            self.elig_thr = thr_key

    def eligible(self, node, thr_key: Tuple[float, float, int]) -> list:
        """Algorithm 2's eligible-GPU list for ``node`` under thresholds
        ``(util, mem, max_residents)``: sorted ``(util, avail_mem, gpu)``
        triples, cached until the node's residency changes."""
        self.ensure_thr(thr_key)
        cached = self.elig[node.id]
        if cached is None:
            thr_util, thr_mem, max_res = thr_key
            cached = []
            residents_per = node.gpu_residents
            util_raw, peak_raw = node.util_raw, node.peak_raw
            for g in range(node.n_gpus):
                u = util_raw[g]
                if u > 100.0:
                    u = 100.0
                m = peak_raw[g]
                if m > 100.0:
                    m = 100.0
                if u > thr_util or m > thr_mem:
                    continue
                if len(residents_per[g]) > max_res:
                    continue
                cached.append((u, 100.0 - m, g))
            cached.sort()  # ascending utilization (ties: most free memory)
            self.elig[node.id] = cached
        return cached

    def cand_parts(self, node, k: int, thr_key: Tuple[float, float, int]) -> tuple:
        """The profile-independent part of ``node``'s Algorithm-2
        candidates at width ``k``: up to two ``(gpu_ids, avail_mem,
        residents, util_sum)`` tuples (hottest-k first, then coldest-k when
        distinct), with the max-residents gate pre-applied.  Each caller
        still applies its job's memory-demand gate (``avail_mem >= need``)
        and attaches the profile's SKU terms.  Cached per (node, width)
        until the node's residency changes — the derived values are exactly
        the reference scan's expressions, so emission is bit-identical."""
        self.ensure_thr(thr_key)
        by_width = self.parts[node.id]
        if by_width is None:
            by_width = {}
            self.parts[node.id] = by_width
        got = by_width.get(k)
        if got is None:
            built = []
            eligible = self.eligible(node, thr_key)
            if len(eligible) >= k:
                max_res = thr_key[2]
                hot_ids: Optional[Tuple[int, ...]] = None
                for chosen in (eligible[-k:], eligible[:k]):  # hot k, cold k
                    gpu_ids = tuple(sorted(g for _, _, g in chosen))
                    if hot_ids is None:
                        hot_ids = gpu_ids
                    elif gpu_ids == hot_ids:
                        continue  # coldest == hottest: one candidate only
                    residents = tuple(sorted(node.residents_on(gpu_ids)))
                    if residents and len(residents) >= max_res:
                        continue
                    avail = 0.0
                    for _, a, _ in chosen:
                        avail += a
                    util = 0.0
                    for u, _, _ in chosen:
                        util += u
                    built.append((gpu_ids, avail, residents, util))
            got = by_width[k] = tuple(built)
        return got

    # ------------------------------------------------------ columnar views

    def power_column(self) -> np.ndarray:
        """The cached per-node draw column (W) as float64.  Callers must
        refresh it first (``Simulator.fleet_power_w`` does)."""
        return np.array(self.power, dtype=np.float64)

    def _build_matrices(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self._matrix_version != self.res_version:
            self._matrices = (
                np.array([n.util_raw for n in self.nodes], dtype=np.float64),
                np.array([n.mem_raw for n in self.nodes], dtype=np.float64),
                np.array([n.peak_raw for n in self.nodes], dtype=np.float64),
            )
            self._matrix_version = self.res_version
        return self._matrices

    def util_matrix(self) -> np.ndarray:
        """(N, G) raw per-GPU utilization, rebuilt per residency version."""
        return self._build_matrices()[0]

    def mem_matrix(self) -> np.ndarray:
        """(N, G) raw per-GPU average memory utilization."""
        return self._build_matrices()[1]

    def peak_matrix(self) -> np.ndarray:
        """(N, G) raw per-GPU peak memory utilization."""
        return self._build_matrices()[2]

    def check_consistency(self, jobs=None) -> None:
        """Assert every index set / column matches the per-node ground
        truth (test hook; O(fleet)).

        With ``jobs`` (a ``{job id -> Job}`` map) the incrementally
        maintained composites are additionally checked against a
        from-scratch recompute: per-GPU ``util_raw``/``mem_raw``/
        ``peak_raw`` resummed from ``gpu_residents`` and the node-level
        host raws resummed from the resident set, each within 1e-9 —
        the float-drift guard for the O(k) maintenance arithmetic."""
        for node in self.nodes:
            i = node.id
            idle = node.is_idle()
            expect_code = _STATE_TO_CODE[node.state]
            assert self.state_code[i] == expect_code, (i, node.state)
            assert self.freq[i] == node.freq, (i, node.freq)
            assert self.host_cpu[i] == node.cpu_raw, (i, node.cpu_raw)
            assert self.host_dram[i] == node.dram_raw, (i, node.dram_raw)
            assert self.host_loader[i] == node.loader_raw, (i, node.loader_raw)
            if jobs is not None:
                self._check_composites(node, jobs)
            in_sets = [
                i in self.on_idle,
                i in self.on_busy,
                i in self.sleep_idle,
                i in self.sleep_busy,
            ]
            if node.state == "failed":
                assert not any(in_sets), i
            else:
                want = {
                    ("on", True): 0,
                    ("on", False): 1,
                    ("sleep", True): 2,
                    ("sleep", False): 3,
                }[(node.state, idle)]
                assert in_sets[want] and sum(in_sets) == 1, (i, in_sets)
            default = node.freq == 1.0 and node.slowdown == 1.0
            if idle and node.state != "failed":
                if default:
                    assert i in self.idle_member[self._class_key(node)], i
                else:
                    assert i in self.odd_idle, i
            else:
                assert i not in self.odd_idle, i
                members = self.idle_member.get(self._class_key(node))
                assert members is None or i not in members, i

    @staticmethod
    def _check_composites(node, jobs) -> None:
        """From-scratch recompute of one node's incrementally maintained
        composites (GPU trio per GPU + node-level host raws), asserting
        each within 1e-9 of the maintained value."""
        for g in range(node.n_gpus):
            u = m = pk = 0.0
            for jid in node.gpu_residents[g]:
                p = jobs[jid].profile
                u += p.gpu_util
                m += p.mem_util
                pk += p.peak_mem_util
            assert abs(node.util_raw[g] - u) <= 1e-9, (node.id, g, u)
            assert abs(node.mem_raw[g] - m) <= 1e-9, (node.id, g, m)
            assert abs(node.peak_raw[g] - pk) <= 1e-9, (node.id, g, pk)
        cpu = dram = loader = 0.0
        for jid in node._resident_count:
            p = jobs[jid].profile
            cpu += p.cpu_util
            dram += p.dram_util
            loader += p.loader_util
        assert abs(node.cpu_raw - cpu) <= 1e-9, (node.id, cpu)
        assert abs(node.dram_raw - dram) <= 1e-9, (node.id, dram)
        assert abs(node.loader_raw - loader) <= 1e-9, (node.id, loader)
