"""Disaggregated host-resource model (Synergy-style).

Twin of ``tests/test_host.py`` through the port's copies, imports re-pointed,
less ``test_fast_candidates_match_reference_on_hosted_trace``: the copies carry
the reference's own disagreement there (ROADMAP C1), and
``tests/test_torch_replay_differential.py`` holds every ``find_candidates``
call of that hosted trace to the reference's answers with ``==`` instead.

Locks the multi-resource co-location extension to its two contracts:

  * absent==disabled — with every host field zero, the host-aware code
    paths are byte-identical to the GPU-only model (inflation, set
    signatures, candidate lists, full-replay metrics);
  * priced end to end — with host demand attached, the contention term,
    the admission gate, the columnar fleet state and the candidate rank
    all see (and agree on) the same node-level host composites.

Also carries the regression tests for the two hot-path bugfixes that
ride along: the ``LatencyHist.fold_ramp`` / ``ramp_slo_violations``
zero-rate guard and the ``JobProfile.speed_on`` required-default
signature (both failed silently before the fix).
"""

import dataclasses
import math
import random

import pytest

from repro_torch.cluster import colocation
from repro_torch.cluster.colocation import (
    HOST_OVERSUB_LIMIT,
    gpu_inflation_factor,
    host_contention_factor,
    inflation_factor,
    set_signature,
)
from repro_torch.cluster.job import (
    HOST_PROFILES,
    HOST_REF_WIDTH,
    Job,
    JobProfile,
    lm_profiles,
    paper_profiles,
)
from repro_torch.cluster.simulator import SimConfig, Simulator
from repro_torch.cluster.trace import (
    TraceConfig,
    attach_host_profiles,
    generate_trace,
    load_into,
    trace_from_csv,
    trace_to_csv,
)
from repro_torch.core.candidates import (
    Thresholds,
    find_candidates,
    find_candidates_reference,
)
from repro_torch.core.eaco import EaCO
from repro_torch.elastic.scaling import reprofile
from repro_torch.serve.models import model_from_profile
from repro_torch.serve.stats import LatencyHist, ramp_slo_violations

PROFILES = paper_profiles()


def _hosted(name: str, width: int = 8) -> JobProfile:
    """``name``'s profile at ``width`` with its HOST_PROFILES row attached."""
    cpu, dram, loader, sens = HOST_PROFILES[name]
    ratio = width / HOST_REF_WIDTH
    base = (PROFILES | lm_profiles())[name]
    return dataclasses.replace(
        base,
        n_gpus=width,
        cpu_util=cpu * ratio,
        dram_util=dram * ratio,
        loader_util=loader * ratio,
        host_sens=sens,
    )


# ------------------------------------------------------ contention factor


def test_host_contention_singleton_and_blind_sets_are_exactly_one():
    assert host_contention_factor([_hosted("alexnet")]) == 1.0
    blind = [PROFILES["alexnet"], PROFILES["resnet50"]]
    assert host_contention_factor(blind) == 1.0
    assert host_contention_factor([]) == 1.0


def test_host_contention_hand_computed():
    """Two alexnets at width 8: CPU demand 190% of supply, every demand
    unit carries sens 0.85 -> stall = 0.85 * 0.9; CPU (worst overshoot
    with max sens) governs over the loader's identical-sens 90% overshoot."""
    a = _hosted("alexnet")
    got = host_contention_factor([a, a])
    assert got == pytest.approx(1.0 + 0.85 * 0.9)


def test_host_contention_weighted_by_demand():
    """A host-hungry job sharing with a near-idle one stalls less than two
    hungry jobs: the insensitive co-resident dilutes the weighted sens."""
    hungry, light = _hosted("alexnet"), _hosted("lm-large")
    both = host_contention_factor([hungry, hungry])
    mixed = host_contention_factor([hungry, light])
    assert 1.0 <= mixed < both


def test_host_contention_under_supply_is_one():
    """No overshoot -> exactly 1.0, even with nonzero sens (demand within
    supply stalls nothing)."""
    small = _hosted("lm-large")  # 12/40/8 at width 8
    assert host_contention_factor([small, small]) == 1.0


def test_inflation_byte_identity_when_host_blind():
    """The absent==disabled contract at the model layer: for host-blind
    sets, ``inflation_factor`` returns the *same float* as the pre-host
    ``gpu_inflation_factor`` (skipped multiply, not ``* 1.0``)."""
    names = list(PROFILES)
    for i in range(len(names)):
        for j in range(i, len(names)):
            s = [PROFILES[names[i]], PROFILES[names[j]]]
            assert inflation_factor(s) == gpu_inflation_factor(s)
    triple = [PROFILES[n] for n in names[:3]]
    assert inflation_factor(triple) == gpu_inflation_factor(triple)


def test_inflation_with_host_demand_exceeds_gpu_only():
    s = [_hosted("alexnet"), _hosted("resnet18")]
    assert inflation_factor(s) > gpu_inflation_factor(s)
    assert inflation_factor(s) == pytest.approx(
        gpu_inflation_factor(s) * host_contention_factor(s)
    )


def test_set_signature_extends_only_when_host_aware():
    blind = set_signature([PROFILES["alexnet"], PROFILES["vgg16"]])
    assert blind == ("alexnet", "vgg16")  # bare names, pre-host key
    aware = set_signature([_hosted("alexnet"), PROFILES["vgg16"]])
    assert aware != blind and any("#h" in t for t in aware)
    # width changes host demand, so widths must not share a history key
    assert set_signature([_hosted("alexnet", 8)]) != set_signature(
        [_hosted("alexnet", 4)]
    )


# ------------------------------------------------- bugfix: speed_on default


def test_speed_on_requires_explicit_default():
    """Regression: ``speed_on`` had ``default=1.0``, so a
    caller forgetting the fleet SKU speed silently pinned every family
    without an override to 1x.  The default is now a required argument."""
    p = PROFILES["alexnet"]
    with pytest.raises(TypeError):
        p.speed_on("a100")  # the old silent-1.0 call shape
    assert p.speed_on("a100", 2.0) == 2.0  # falls through to the SKU speed
    assert p.speed_on(None, 2.0) == 1.0  # no SKU -> reference node
    override = dataclasses.replace(p, sku_speed=(("a100", 1.4),))
    assert override.speed_on("a100", 2.0) == 1.4


def test_node_job_speed_keeps_fleet_sku_speed():
    """End-to-end half of the regression: on a hetero fleet, a family
    WITHOUT a per-SKU override must run at the a100's fleet speed (2x),
    not at the silent 1.0 the old default would have returned."""
    from repro_torch.cluster.power import fleet_skus

    sim = Simulator(
        SimConfig(n_nodes=2, seed=0, node_skus=fleet_skus(2, (("a100", 1.0),))),
        EaCO(),
    )
    node = sim.nodes[0]
    assert node.sku.name == "a100" and node.sku.speed > 1.0
    assert node.job_speed(PROFILES["alexnet"]) == node.sku.speed


# ------------------------------------------- bugfix: zero-rate ramp guard


@pytest.mark.parametrize("rate", [0.0, -1.0, math.inf, math.nan])
def test_fold_ramp_rejects_degenerate_rates(rate):
    """Regression: a throttled-to-stall replica reports a
    zero drain rate; ``fold_ramp`` divided by it — ``ZeroDivisionError``
    at exactly 0.0, silent ``inf`` poisoning of ``sum_s``/``max_s`` for
    denormal negatives.  Now a loud ``ValueError`` either way."""
    h = LatencyHist()
    with pytest.raises(ValueError, match="drain rate"):
        h.fold_ramp(1.0, rate, 10)
    # and the histogram stays untouched by the rejected fold
    assert h.total == 0.0 and h.sum_s == 0.0 and h.max_s == 0.0


@pytest.mark.parametrize("rate", [0.0, -2.5, math.inf, math.nan])
def test_ramp_slo_violations_rejects_degenerate_rates(rate):
    with pytest.raises(ValueError, match="drain rate"):
        ramp_slo_violations(1.0, rate, 10, 5.0)


def test_zero_request_ramps_short_circuit_before_the_guard():
    """n=0 has no ramp at all: both helpers return before the rate guard,
    so an idle replica with a (meaningless) zero rate stays legal."""
    h = LatencyHist()
    h.fold_ramp(1.0, 0.0, 0)
    assert h.total == 0.0
    assert ramp_slo_violations(1.0, 0.0, 0, 5.0) == 0.0


def test_fold_ramp_overflow_bucket_clamp():
    """Ramps past ``hi_s`` land in the unbounded last bucket while the
    exact accumulators keep the true values (documented clamp semantics)."""
    h = LatencyHist(lo_s=1e-3, hi_s=10.0, n_buckets=8)
    h.fold_ramp(wait_s=20.0, rate_rps=1.0, n=5)  # entirely above hi_s
    assert h.counts[-1] == pytest.approx(5.0)
    assert h.max_s == pytest.approx(25.0)
    assert h.mean_s == pytest.approx(22.5)


# ------------------------------------------------------- trace attachment


def test_attach_host_profiles_scales_with_width():
    trace = generate_trace(TraceConfig(n_jobs=120, seed=0, elastic_frac=0.5))
    hosted = attach_host_profiles(trace)
    assert len(hosted) == len(trace)
    for (orig, t0, d0), (prof, t1, d1) in zip(trace, hosted):
        assert (t0, d0) == (t1, d1)
        row = HOST_PROFILES.get(orig.name)
        if row is None:
            assert prof is orig
            continue
        ratio = orig.n_gpus / HOST_REF_WIDTH
        assert prof.cpu_util == row[0] * ratio
        assert prof.dram_util == row[1] * ratio
        assert prof.loader_util == row[2] * ratio
        assert prof.host_sens == row[3]
        # only host fields differ from the source profile
        assert dataclasses.replace(
            prof, cpu_util=0.0, dram_util=0.0, loader_util=0.0, host_sens=0.0
        ) == orig


def test_attach_host_profiles_is_idempotent():
    trace = generate_trace(TraceConfig(n_jobs=30, seed=1))
    once = attach_host_profiles(trace)
    twice = attach_host_profiles(once)
    assert all(a is b for (a, _, _), (b, _, _) in zip(once, twice))


def test_reprofile_scales_host_demand_not_sens():
    p = _hosted("resnet50", width=8)
    grown = reprofile(p, 12)
    assert grown.cpu_util == pytest.approx(p.cpu_util * 1.5)
    assert grown.dram_util == pytest.approx(p.dram_util * 1.5)
    assert grown.loader_util == pytest.approx(p.loader_util * 1.5)
    assert grown.host_sens == p.host_sens  # a property of the family
    blind = reprofile(PROFILES["resnet50"], 12)
    assert not blind.has_host_demand


def test_csv_roundtrip_preserves_host_columns(tmp_path):
    trace = attach_host_profiles(
        generate_trace(TraceConfig(n_jobs=40, seed=2, elastic_frac=0.4))
    )
    path = str(tmp_path / "trace.csv")
    trace_to_csv(trace, path)
    loaded = trace_from_csv(path)
    assert loaded == trace


def test_csv_without_host_columns_loads_host_blind(tmp_path):
    """Pre-host CSVs (no host columns at all) must keep loading, with every
    host field at 0.0 — the loader's absent==disabled contract."""
    trace = generate_trace(TraceConfig(n_jobs=10, seed=3))
    full = tmp_path / "full.csv"
    trace_to_csv(trace, str(full))
    lines = full.read_text().splitlines()
    header = lines[0].split(",")
    keep = [i for i, col in enumerate(header)
            if col not in ("cpu_util", "dram_util", "loader_util", "host_sens")]
    legacy = tmp_path / "legacy.csv"
    legacy.write_text(
        "\n".join(",".join(ln.split(",")[i] for i in keep) for ln in lines)
        + "\n"
    )
    loaded = trace_from_csv(str(legacy))
    assert loaded == trace
    assert all(not p.has_host_demand for p, _, _ in loaded)


# ------------------------------------------------------- serve derivation


def test_serve_models_derive_host_share():
    train = _hosted("resnet50", width=8)
    m = model_from_profile(train)
    # one-GPU share of the 8-GPU training row, scaled by the serve fractions
    assert m.cpu_util == pytest.approx(train.cpu_util / 8 * 0.5)
    assert m.dram_util == pytest.approx(train.dram_util / 8 * 0.5)
    assert m.loader_util == pytest.approx(train.loader_util / 8 * 0.1)
    assert m.host_sens == pytest.approx(train.host_sens * 0.5)
    prof = m.profile()
    assert prof.has_host_demand and prof.name == "serve:resnet50"


def test_serve_models_stay_blind_for_blind_profiles():
    """Zero training host demand derives zero serving demand — no clamp
    floor invents host load from nothing."""
    m = model_from_profile(PROFILES["resnet50"])
    assert (m.cpu_util, m.dram_util, m.loader_util, m.host_sens) == (
        0.0, 0.0, 0.0, 0.0,
    )
    assert not m.profile().has_host_demand


# -------------------------------------------------- admission + candidates


def _empty_sim(n_nodes=3):
    return Simulator(SimConfig(n_nodes=n_nodes, seed=0), EaCO())


def _place(sim, node_id, job_id, prof, gpus):
    job = Job(id=job_id, profile=prof, arrival=0.0, deadline=math.inf)
    sim.jobs[job.id] = job
    sim.nodes[node_id].add_job(job, gpus)
    return job


def test_candidate_host_gate_excludes_oversubscribed_nodes():
    sim = _empty_sim()
    # node 0 already hosts an alexnet: 95% CPU / 95% loader demand
    _place(sim, 0, 1, _hosted("alexnet"), range(8))
    newcomer = Job(
        id=2, profile=_hosted("resnet18"), arrival=0.0, deadline=math.inf
    )
    sim.jobs[newcomer.id] = newcomer
    th = Thresholds()
    for finder in (find_candidates, find_candidates_reference):
        cands = finder(sim, newcomer, th)
        # 95 + 80 CPU and 95 + 75 loader both bust the 130% cap: node 0
        # must not appear; the idle nodes carry zero host_over
        assert cands, finder.__name__
        assert all(c.node_id != 0 for c in cands), finder.__name__
        assert all(c.host_over == 0.0 for c in cands), finder.__name__
    # a host-blind scheduler (threshold inf) sees node 0 again, and its
    # candidates price the overshoot in host_over for the rank key
    blind = find_candidates(sim, newcomer, Thresholds(host=math.inf))
    on_zero = [c for c in blind if c.node_id == 0]
    assert on_zero and all(
        c.host_over == pytest.approx(95.0 + 80.0 - 100.0) for c in on_zero
    )


def test_candidate_host_gate_infeasible_job_returns_empty():
    """A single job whose own demand busts the cap can never place."""
    sim = _empty_sim()
    huge = dataclasses.replace(_hosted("alexnet"), cpu_util=HOST_OVERSUB_LIMIT + 1)
    job = Job(id=1, profile=huge, arrival=0.0, deadline=math.inf)
    sim.jobs[job.id] = job
    assert find_candidates(sim, job, Thresholds()) == []
    assert find_candidates_reference(sim, job, Thresholds()) == []


def test_pick_gpus_and_resize_enforce_host_cap():
    sim = _empty_sim()
    _place(sim, 0, 1, _hosted("alexnet"), range(8))
    over = Job(id=2, profile=_hosted("resnet18"), arrival=0.0, deadline=math.inf)
    sim.jobs[over.id] = over
    assert sim.pick_gpus(sim.nodes[0], 8, over) is None
    blind = Job(id=3, profile=PROFILES["resnet18"], arrival=0.0, deadline=math.inf)
    sim.jobs[blind.id] = blind
    assert sim.pick_gpus(sim.nodes[0], 8, blind) is not None


def test_candidates_byte_identical_for_host_blind_jobs():
    """The full absent==disabled contract at the scheduler layer: on a
    mid-replay fleet of host-blind jobs, a host-aware EaCO and a
    ``host_aware=False`` EaCO produce identical replay metrics."""
    trace = generate_trace(TraceConfig(n_jobs=25, seed=4))

    def run(**kw):
        sim = Simulator(SimConfig(n_nodes=5, seed=0), EaCO(queue_window=8, **kw))
        load_into(sim, trace)
        sim.run(until=50_000)
        return sim.results()

    assert run() == run(host_aware=False)


def test_hosted_trace_changes_the_replay():
    """Attached host demand must actually be priced by the world — the
    hosted replay cannot coincide with the host-blind one (the scheduler
    both spreads host-hungry jobs and pays contention where it co-locates).
    Together with the byte-identity test above, this pins 'zero == no-op,
    nonzero == effect'."""

    def run(trace):
        sim = Simulator(SimConfig(n_nodes=4, seed=0), EaCO(queue_window=8))
        load_into(sim, trace)
        sim.run(until=200_000)
        return sim.results()

    base = generate_trace(TraceConfig(n_jobs=30, seed=5))
    blind, hosted = run(base), run(attach_host_profiles(base))
    assert hosted["jobs_done"] == blind["jobs_done"] == 30
    assert hosted != blind


# --------------------------------------------- churn property


def test_churn_composites_survive_10k_random_cycles():
    """Property lock: 10k random add/remove/resize cycles on
    a live fleet keep every incrementally-maintained composite — per-GPU
    util/mem/peak and the node-level host raws — within 1e-9 of a
    from-scratch recompute (``FleetState.check_consistency(jobs)``)."""
    sim = _empty_sim(n_nodes=6)
    rng = random.Random(0)
    families = ["alexnet", "resnet18", "resnet50", "vgg16",
                "lm-small", "lm-medium", "lm-large", "lm-moe"]
    resident = {}  # job id -> (job, node_id)
    next_id = 0
    for step in range(10_000):
        op = rng.random()
        if op < 0.55 or not resident:
            nid = rng.randrange(len(sim.nodes))
            node = sim.nodes[nid]
            width = rng.choice([1, 2, 3, 4, 6, 8])
            prof = _hosted(rng.choice(families), width=width)
            if rng.random() < 0.2:  # keep host-blind jobs in the churn too
                prof = dataclasses.replace(
                    prof, cpu_util=0.0, dram_util=0.0,
                    loader_util=0.0, host_sens=0.0,
                )
            gpus = rng.sample(range(node.n_gpus), min(width, node.n_gpus))
            job = Job(id=next_id, profile=prof, arrival=0.0, deadline=math.inf)
            next_id += 1
            sim.jobs[job.id] = job
            node.add_job(job, gpus)
            resident[job.id] = (job, nid)
        elif op < 0.85:
            jid = rng.choice(list(resident))
            job, nid = resident.pop(jid)
            sim.nodes[nid].remove_job(job)
            del sim.jobs[jid]
        else:  # resize: remove, re-reference the width, re-place
            jid = rng.choice(list(resident))
            job, nid = resident[jid]
            node = sim.nodes[nid]
            node.remove_job(job)
            new_w = rng.choice([1, 2, 4, 8])
            job.profile = reprofile(job.profile, new_w)
            gpus = rng.sample(range(node.n_gpus), min(new_w, node.n_gpus))
            node.add_job(job, gpus)
        if step % 1000 == 999:
            sim.fleet.check_consistency(sim.jobs)
    sim.fleet.check_consistency(sim.jobs)
    # drain everything: the empty fleet must squash all residual drift
    for jid in list(resident):
        job, nid = resident.pop(jid)
        sim.nodes[nid].remove_job(job)
    sim.fleet.check_consistency(sim.jobs)
    for node in sim.nodes:
        assert node.cpu_raw == node.dram_raw == node.loader_raw == 0.0
