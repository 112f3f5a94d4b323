"""DVFS + power-cap invariants.

Locks the three contracts the subsystem is built on:

  * ladder monotonicity — power nondecreasing in frequency, throughput
    factor in (0, 1] and sublinear (>= f), and the top step reproducing
    the legacy ``PowerModel`` / time factors *exactly* (1e-12);
  * cap safety — a full replay under ``SimConfig.power_cap_w`` never
    exceeds the cap at any event timestamp, for the cap-aware scheduler
    AND for a cap-oblivious one (the enforcer alone must hold the line);
  * enforcement policy — throttle least-SLO-risk nodes first, settle
    energy at the frequency that actually held over each interval.
"""

import math

import pytest

from repro_torch.cluster import dvfs
from repro_torch.cluster.job import JobProfile, paper_profiles
from repro_torch.cluster.node import Node
from repro_torch.cluster.power import get_sku, sku_registry, v100_power_model
from repro_torch.cluster.simulator import SimConfig, Simulator
from repro_torch.cluster.trace import TraceConfig, generate_trace, load_into
from repro_torch.core.eaco import EaCO
from repro_torch.core.eaco_powercap import EaCOPowerCap

UTILS = (0.0, 10.0, 25.0, 50.0, 75.0, 100.0)


# --------------------------------------------------------------- the ladder


def test_ladders_ascend_and_end_at_top():
    for name in sku_registry():
        ladder = dvfs.ladder_for(name)
        assert ladder.steps[-1] == 1.0
        assert all(a < b for a, b in zip(ladder.steps, ladder.steps[1:]))
        assert all(0.0 < s <= 1.0 for s in ladder.steps)
        assert ladder.freq(ladder.top) == 1.0


def test_ladder_validation():
    with pytest.raises(ValueError):
        dvfs.FrequencyLadder((0.5, 0.8))  # top != 1.0
    with pytest.raises(ValueError):
        dvfs.FrequencyLadder((0.8, 0.5, 1.0))  # not ascending
    with pytest.raises(ValueError):
        dvfs.FrequencyLadder((-0.1, 1.0))  # out of range
    with pytest.raises(IndexError):
        dvfs.ladder_for("v100").freq(-1)  # underflow must not wrap


def test_power_nondecreasing_in_frequency():
    for name in sku_registry():
        pm = get_sku(name).power
        ladder = dvfs.ladder_for(name)
        for u in UTILS:
            draws = [pm.node_power_at(u, f) for f in ladder.steps]
            assert all(a <= b + 1e-12 for a, b in zip(draws, draws[1:])), (
                name, u, draws,
            )
            # a reduced step never draws below the static floor
            assert all(d >= pm.idle_w - 1e-12 for d in draws)


def test_top_step_reproduces_legacy_power_model_exactly():
    for name in sku_registry():
        pm = get_sku(name).power
        for u in UTILS:
            assert abs(pm.node_power_at(u, 1.0) - pm.node_power(u)) <= 1e-12


def test_throughput_factor_sublinear_slowdown():
    for duty in UTILS:
        assert dvfs.throughput_factor(1.0, duty) == 1.0
        assert dvfs.time_multiplier(1.0, duty) == 1.0
        prev = 0.0
        for f in (0.4, 0.55, 0.7, 0.85, 0.99):
            tput = dvfs.throughput_factor(f, duty)
            assert 0.0 < tput <= 1.0
            assert tput >= f - 1e-12  # sublinear slowdown
            assert tput >= prev  # monotone in frequency
            assert dvfs.time_multiplier(f, duty) >= 1.0
            prev = tput
    # compute-bound jobs lose more speed than input-bound ones
    assert dvfs.throughput_factor(0.6, 100.0) < dvfs.throughput_factor(0.6, 5.0)


def test_top_step_time_factor_exact():
    prof = paper_profiles()["resnet50"]
    node = Node(0, 8)
    assert node.time_factor_at(prof, 1.0) == node.time_factor(prof)
    assert node.time_factor_at(prof, 0.55) > node.time_factor(prof)


# ------------------------------------------------------- simulator plumbing


def _one_job_sim(power_cap_w: float = 0.0, scheduler=None):
    sim = Simulator(
        SimConfig(n_nodes=2, seed=0, prediction_noise=0.0, power_cap_w=power_cap_w),
        scheduler or EaCO(),
    )
    prof = paper_profiles()["resnet50"]
    sim.add_job(prof, arrival=0.0, deadline=math.inf)
    return sim, prof


def test_set_frequency_slows_job_and_cuts_power():
    sim, prof = _one_job_sim()
    sim.run(until=1.0)
    node = sim.nodes[sim.jobs[0].node_id]
    p_full = node.current_power_w(sim.jobs, sim.power)
    e_full = dict((n.id, n.energy_kwh) for n in sim.nodes)
    sim.set_frequency(node.id, 0)  # ladder floor
    assert node.freq == dvfs.node_ladder(node).freq(0)
    assert node.target_step == 0
    p_slow = node.current_power_w(sim.jobs, sim.power)
    assert p_slow < p_full
    done_before = sim.jobs[0].epochs_done
    sim.run(until=2.0)
    # progress continued, but slower than the full-clock rate
    rate_slow = (sim.jobs[0].epochs_done - done_before) / 1.0
    assert 0 < rate_slow < 1.0 / prof.epoch_hours
    # the interval after the switch accrued at the reduced draw
    de = sim.nodes[node.id].energy_kwh - e_full[node.id]
    assert de == pytest.approx(p_slow * 1.0 / 1000.0, rel=1e-9)


def test_set_frequency_event_payload():
    sim, _ = _one_job_sim()
    sim.push(1.0, "set_frequency", {"node": 0, "step": 0})
    sim.run(until=1.5)
    assert sim.nodes[0].freq_step == 0
    assert sim.freq_change_count >= 1


def test_set_frequency_validates_step():
    sim, _ = _one_job_sim()
    with pytest.raises(IndexError):
        sim.set_frequency(0, 99)


# ------------------------------------------------------------ cap enforcement


def test_enforcer_throttles_least_slo_risk_first():
    sim = Simulator(
        SimConfig(n_nodes=2, seed=0, prediction_noise=0.0), EaCO()
    )
    prof = paper_profiles()["vgg16"]
    tight = sim.add_job(prof, arrival=0.0, deadline=prof.base_jct_hours * 1.05)
    sim.add_job(prof, arrival=0.0, deadline=math.inf)
    sim.run(until=0.5)
    assert {sim.jobs[0].node_id, sim.jobs[1].node_id} == {0, 1}
    # cap just below the current two-node draw: exactly one step-down needed
    cap = sim.fleet_power_w() - 1.0
    sim.power_cap = dvfs.PowerCapEnforcer(cap)
    sim.power_cap.enforce(sim)
    assert sim.fleet_power_w() <= cap + 1e-9
    risky_node = sim.nodes[tight.node_id]
    lax_node = sim.nodes[sim.jobs[1].node_id]
    assert lax_node.freq < 1.0  # the no-SLO resident got throttled
    assert risky_node.freq == 1.0  # the tight-deadline one did not


def test_enforcer_raises_back_up_to_target_when_headroom_returns():
    sim = Simulator(
        SimConfig(n_nodes=1, seed=0, prediction_noise=0.0), EaCO()
    )
    prof = paper_profiles()["vgg16"]
    sim.add_job(prof, arrival=0.0, deadline=math.inf)
    sim.run(until=0.5)
    node = sim.nodes[sim.jobs[0].node_id]
    cap = sim.fleet_power_w() - 1.0
    enf = sim.power_cap = dvfs.PowerCapEnforcer(cap)
    enf.enforce(sim)
    assert node.freq < 1.0 and enf.throttle_count >= 1
    enf.cap_w = cap * 10  # headroom returns
    enf.enforce(sim)
    assert node.freq == 1.0 and enf.raise_count >= 1
    # ... but never above a scheduler-chosen target
    sim.set_frequency(node.id, 1)
    enf.enforce(sim)
    assert node.freq_step == 1


@pytest.mark.parametrize("make_sched", [EaCOPowerCap, EaCO])
def test_power_cap_never_exceeded_full_replay(make_sched):
    """Replay 60 jobs under an 80% cap: the peak fleet draw at every event
    timestamp stays under the cap, whether the scheduler is cap-aware
    (EaCOPowerCap) or oblivious (EaCO + enforcer alone)."""
    trace = generate_trace(TraceConfig(n_jobs=60, seed=0))
    sim = Simulator(SimConfig(n_nodes=16, seed=0), EaCO())
    load_into(sim, trace)
    sim.run(until=100_000)
    uncapped = sim.results()
    assert uncapped["jobs_done"] == 60
    cap = uncapped["peak_fleet_power_w"] * 0.8

    sim = Simulator(
        SimConfig(n_nodes=16, seed=0, power_cap_w=cap), make_sched()
    )
    load_into(sim, trace)
    sim.run(until=100_000)
    r = sim.results()
    assert r["jobs_done"] == 60
    assert r["peak_fleet_power_w"] <= cap + 1e-6
    assert r["cap_infeasible_events"] == 0


def test_powercap_uncapped_saves_energy_with_bounded_jct():
    """Even without a cap, EaCOPowerCap's energy-per-epoch step choice
    beats plain EaCO on energy at a bounded JCT premium."""
    trace = generate_trace(TraceConfig(n_jobs=60, seed=0))
    results = {}
    for name, sched in (("eaco", EaCO()), ("powercap", EaCOPowerCap())):
        sim = Simulator(SimConfig(n_nodes=16, seed=0), sched)
        load_into(sim, trace)
        sim.run(until=100_000)
        results[name] = sim.results()
        assert results[name]["jobs_done"] == 60
    assert (
        results["powercap"]["total_energy_kwh"]
        < results["eaco"]["total_energy_kwh"]
    )
    assert results["powercap"]["avg_jct_h"] <= results["eaco"]["avg_jct_h"] * 1.08


def test_fallback_placement_never_retargets_a_throttled_node():
    """A placement taken beyond the joint-search budget runs at the node's
    current (possibly enforcer-throttled) step but must not make that step
    the scheduler target — that would block the enforcer's raise-back."""
    sched = EaCOPowerCap(candidate_limit=0)  # every placement is a fallback
    sim = Simulator(
        SimConfig(n_nodes=2, seed=0, prediction_noise=0.0), sched
    )
    prof = paper_profiles()["resnet50"]
    sim.add_job(prof, arrival=0.0, deadline=math.inf)
    sim.run(until=1.0)
    node = sim.nodes[sim.jobs[0].node_id]
    assert node.target_step is None  # fallback never called set_frequency
    # a throttled node keeps raise-back headroom after such a placement
    sim.power_cap = dvfs.PowerCapEnforcer(sim.fleet_power_w() - 1.0)
    sim.power_cap.enforce(sim)
    assert node.freq < 1.0
    sim.power_cap.cap_w *= 10
    sim.power_cap.enforce(sim)
    assert node.freq == 1.0  # raise-back reached the ladder top again


def test_frequency_unaware_runs_report_no_dvfs_activity():
    trace = generate_trace(TraceConfig(n_jobs=20, seed=1))
    sim = Simulator(SimConfig(n_nodes=8, seed=1), EaCO())
    load_into(sim, trace)
    sim.run(until=100_000)
    r = sim.results()
    assert r["freq_change_count"] == 0
    assert r["cap_throttle_count"] == r["cap_raise_count"] == 0
    assert all(n.freq == 1.0 for n in sim.nodes)
    assert r["peak_fleet_power_w"] > 0
