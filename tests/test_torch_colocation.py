"""The port's co-location path against the JAX package's: the stepper and
profiler, the cluster and core modules EaCO schedules with, and the
calibration bridge.

The pure-Python modules are copies, so their numbers must equal the
reference's exactly (``==``): the paper's tables and power models, the
analytic inflation model, the History, the JCT predictor, the dry-run
measurement of every default signature, and the bytes of a saved
calibration. The stepper runs real smoke-sized train steps on the CPU: from
the same fp32 parameters (carried over with ``from_jax_params``) and the same
batches, the JAX stepper's and the port's per-step losses agree within 1e-4
relative (the tolerance of ``test_torch_train.py``'s train-step parity), and
an evicted job's restored parameters within 1e-4 relative L2. A frontend
config is fed the port's seeded stand-in embeddings in both steppers (the
reference feeds zeros, ROADMAP C5), through a test-local subclass of the JAX
stepper. Twins of the JAX package's system and bridge tests keep their
tolerances.
"""

import dataclasses
import functools
import itertools
import json
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.bridge import calibrate as jcal
from repro.bridge import profiles as jprofiles
from repro.cluster import colocation as jcolo
from repro.cluster import job as jjob
from repro.cluster import power as jpower
from repro.colocation.stepper import ColocatedJob as JaxColocatedJob
from repro.colocation.stepper import TemporalStepper as JaxTemporalStepper
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.core.history import History as JaxHistory
from repro.core.predictor import JCTPredictor as JaxJCTPredictor
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticPipeline as JaxSyntheticPipeline
from repro.elastic import scaling as jscaling
from repro.optim.schedules import constant as jax_constant
from repro.roofline import hw as jhw
from repro.train.steps import make_train_bundle as jax_make_train_bundle

from repro_torch.bridge import (
    ANALYTIC_TOLERANCE,
    HISTORY_TOLERANCE,
    Calibration,
    analytic_job,
    build_calibration,
    default_signatures,
    measure_signature,
)
from repro_torch.bridge import profiles as bridge_profiles
from repro_torch.cluster import colocation
from repro_torch.cluster import power
from repro_torch.cluster.job import HOST_PROFILES, Job, JobProfile, lm_profiles, paper_profiles
from repro_torch.colocation.profiler import EarlyStageProfiler
from repro_torch.colocation.stepper import AnalyticBundle, ColocatedJob, TemporalStepper
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.history import History
from repro_torch.core.predictor import JCTPredictor
from repro_torch.data.frontend import frontend_embeds
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.elastic import scaling
from repro_torch.models.params import from_jax_params
from repro_torch.optim.schedules import constant
from repro_torch.roofline import hw
from repro_torch.train.steps import make_train_bundle
from repro_torch.tree import leaves, leaves_with_paths

STEP_RTOL = 1e-4  # tests/test_torch_train.py::test_train_steps_track_jax
PARAM_RTOL = 1e-4
LR = 1e-3
SEQ, BATCH = 64, 2  # the JAX package's tests/test_system.py::_job


# ---------------------------------------------------------------- twins of tests/test_system.py


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The smoke shapes gain nothing from intra-op threads; one torch thread
    keeps the ``-n 6`` workers on a few cores from slowing each other's
    small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _job(arch, seed=0, ckpt_dir=None, steps_per_epoch=4, target_epochs=2):
    cfg = smoke_config(get_config(arch))
    bundle = make_train_bundle(cfg)
    pipe = SyntheticPipeline(DataConfig(cfg.vocab_size, seq_len=SEQ, global_batch=BATCH, seed=seed))
    return ColocatedJob(name=arch, bundle=bundle, pipeline=pipe, steps_per_epoch=steps_per_epoch,
                        target_epochs=target_epochs, ckpt_dir=ckpt_dir)


def test_temporal_stepper_two_jobs_progress():
    jobs = [_job("minitron-8b", 0), _job("mamba2-370m", 1)]
    stepper = TemporalStepper(jobs, device="cpu")
    report = stepper.run(max_rounds=16)
    for name, r in report.items():
        assert r["steps"] == 8  # 4 steps/epoch x 2 epochs
        assert np.isfinite(r["final_loss"])


def test_stepper_evict_restores_epoch_checkpoint():
    with tempfile.TemporaryDirectory() as d:
        jobs = [_job("mamba2-370m", 0, ckpt_dir=d, steps_per_epoch=3, target_epochs=3)]
        stepper = TemporalStepper(jobs, device="cpu")
        for _ in range(4):  # epoch boundary at step 3, then 1 extra step
            stepper.step_round()
        job = stepper.evict("mamba2-370m")
        assert job.step == 3, "evict must roll back to the epoch checkpoint"


def test_early_stage_profiler_reports_inflation():
    jobs = [_job("minitron-8b", 0), _job("internvl2-2b", 1)]
    prof = EarlyStageProfiler(flops_per_step={j.name: 1e9 for j in jobs})
    stepper = TemporalStepper(jobs, device="cpu")
    solo = prof.profile_solo(stepper, steps=2)
    obs = prof.observe(stepper, rounds=2)
    for name in solo:
        assert solo[name].mean_step_s > 0
        assert obs[name].inflation_vs_solo is not None
        assert 0 < obs[name].duty_cycle_pct <= 100.0


def test_stepper_initialises_on_the_device_it_is_given():
    """A job without state is initialised on ``device``, the next job from
    the next seed; one with state keeps it; an analytic bundle gets no device."""
    a, b = _job("mamba2-370m"), _job("mamba2-370m")
    TemporalStepper([a], seed=3, device="cpu")
    TemporalStepper([_job("minitron-8b"), b], seed=2, device="cpu")
    assert all(t.device.type == "cpu" for t in leaves(a.params))
    assert all(torch.equal(x, y) for x, y in zip(leaves(a.params), leaves(b.params)))
    kept = leaves(a.params)
    TemporalStepper([a], seed=0, device="meta")
    assert all(x is y for x, y in zip(kept, leaves(a.params)))
    p = paper_profiles()["resnet18"]
    job = analytic_job(p)
    TemporalStepper([job], device="meta")
    assert job.params == () and job.opt_state == ()


def test_a_frontend_is_fed_the_trainers_seeded_embeddings():
    """Not the reference's zeros (ROADMAP C5): ``frontend_embeds`` of (data seed, step)."""
    job = _job("internvl2-2b", seed=5)
    stepper = TemporalStepper([job], device="cpu")
    job.step = 3
    fe = stepper._make_batch(job)["frontend_embeds"]
    cfg = job.bundle.cfg
    assert torch.equal(fe, frontend_embeds(cfg, BATCH, 5, 3, "cpu"))
    assert fe.dtype == torch.bfloat16 and float(fe.float().abs().max()) > 0


# ---------------------------------------------------------------- stepper parity with the JAX stepper


@functools.lru_cache(maxsize=None)
def _bundles(arch):
    jcfg = jax_smoke_config(jax_get_config(arch))
    jbundle = jax_make_train_bundle(jcfg, lr_schedule=jax_constant(LR))
    bundle = make_train_bundle(smoke_config(get_config(arch)), lr_schedule=constant(LR))
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jbundle.model.init(jax.random.PRNGKey(0)))
    return jbundle, bundle, jparams


def _pair(arch, data_seed, ckpt_dirs=(None, None), steps_per_epoch=2, target_epochs=2):
    """The same job for each stepper: the same fp32 parameters and data."""
    jbundle, bundle, jparams = _bundles(arch)
    jp = jax.tree.map(jnp.copy, jparams)  # the JAX step donates its inputs
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu", defs=bundle.model.param_defs())
    vocab = bundle.cfg.vocab_size
    jjob_ = JaxColocatedJob(arch, jbundle, JaxSyntheticPipeline(JaxDataConfig(vocab, SEQ, BATCH, seed=data_seed)),
                            steps_per_epoch, target_epochs, ckpt_dirs[0],
                            params=jp, opt_state=jbundle.optimizer.init(jp))
    job = ColocatedJob(arch, bundle, SyntheticPipeline(DataConfig(vocab, SEQ, BATCH, seed=data_seed)),
                       steps_per_epoch, target_epochs, ckpt_dirs[1],
                       params=params, opt_state=bundle.optimizer.init(params))
    return jjob_, job


class _SharedFrontendStepper(JaxTemporalStepper):
    """The JAX stepper fed the port's seeded frontend embeddings in place of
    zeros, so that both steppers see the same batches (ROADMAP C5)."""

    def _make_batch(self, job):
        batch = super()._make_batch(job)
        if "frontend_embeds" in batch:
            fe = frontend_embeds(job.bundle.cfg, BATCH, job.pipeline.cfg.seed, job.step, "cpu")
            batch["frontend_embeds"] = jnp.asarray(fe.float().numpy()).astype(jnp.bfloat16)
        return batch


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_stepper_tracks_the_jax_stepper():
    """minitron-8b, mamba2-370m and internvl2-2b co-located, 2 epochs x 2
    steps, round robin in both packages: every job's per-step losses, and the
    reports' steps and epochs."""
    archs = ("minitron-8b", "mamba2-370m", "internvl2-2b")
    pairs = [_pair(arch, seed) for seed, arch in enumerate(archs)]
    jreport = _SharedFrontendStepper([j for j, _ in pairs]).run(max_rounds=10)
    report = TemporalStepper([t for _, t in pairs], device="cpu").run(max_rounds=10)
    assert sorted(report) == sorted(jreport) == sorted(archs)
    for (jj, job), arch in zip(pairs, archs):
        assert len(job.losses) == len(jj.losses) == 4
        np.testing.assert_allclose(job.losses, jj.losses, rtol=STEP_RTOL, err_msg=arch)
        assert all(np.isfinite(job.losses))
        for key in ("steps", "epochs"):
            assert report[arch][key] == jreport[arch][key], (arch, key)
        assert job.done and jj.done


def test_evict_matches_the_jax_stepper(tmp_path):
    """mamba2-370m, 2 steps an epoch, 3 steps, then ``evict``: both roll back
    to step 2; the port's parameters and optimizer state equal its own
    epoch-2 snapshot exactly, and the parameters the reference's within 1e-4."""
    jj, job = _pair("mamba2-370m", 0, ckpt_dirs=(str(tmp_path / "jax"), str(tmp_path / "torch")),
                    target_epochs=3)
    jstepper = JaxTemporalStepper([jj])
    stepper = TemporalStepper([job], device="cpu")
    snapshot = None
    for _ in range(3):
        jstepper.step_round()
        stepper.step_round()
        if job.step == 2:
            snapshot = [t.clone() for t in leaves({"params": job.params, "opt": job.opt_state})]
    jevicted, evicted = jstepper.evict("mamba2-370m"), stepper.evict("mamba2-370m")
    assert evicted.step == jevicted.step == 2
    assert stepper.jobs == [] and jstepper.jobs == []
    restored = leaves({"params": evicted.params, "opt": evicted.opt_state})
    assert len(restored) == len(snapshot)
    assert all(torch.equal(a, b) for a, b in zip(restored, snapshot))
    jleaves = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
               for path, v in jax.tree_util.tree_leaves_with_path(jevicted.params)}
    for path, t in leaves_with_paths(evicted.params):
        assert _rel_l2(t.numpy(), jleaves[path]) <= PARAM_RTOL, path


# ---------------------------------------------------------------- the analytic bridge vs the reference


@pytest.fixture(scope="module")
def reference_calibration():
    return jcal.build_calibration()


@pytest.fixture(scope="module")
def profiles(reference_calibration):
    """The reference's roofline-derived family profiles as the port's ``JobProfile``."""
    return {name: JobProfile(**dataclasses.asdict(p)) for name, p in reference_calibration.profiles.items()}


@pytest.fixture(scope="module")
def calibration(profiles, reference_calibration):
    return build_calibration(profiles, list(reference_calibration.signatures))


def test_measure_signature_equals_the_reference(profiles, reference_calibration):
    """Every default signature, measured through the port's stepper and
    profiler on analytic bundles: equal to the reference's, bit for bit."""
    sigs = default_signatures(profiles)
    assert sigs == jcal.default_signatures(reference_calibration.profiles) and len(sigs) >= 20
    for sig in sigs:
        got = measure_signature([profiles[n] for n in sig])
        assert got == jcal.measure_signature([reference_calibration.profiles[n] for n in sig]), sig
        assert got == reference_calibration.signatures[sig], sig


def test_analytic_bundles_equal_the_reference(profiles, reference_calibration):
    """The virtual clock and loss curve of ``AnalyticBundle``, member by member."""
    names = sorted(profiles)[:4]
    ours = [analytic_job(profiles[n]).bundle for n in names]
    theirs = [jcal.analytic_job(reference_calibration.profiles[n]).bundle for n in names]
    assert [dataclasses.asdict(b) for b in ours] == [dataclasses.asdict(b) for b in theirs]
    for k in range(1, 5):
        for a, b in zip(ours[:k], theirs[:k]):
            assert a.step_seconds(ours[:k]) == b.step_seconds(theirs[:k])
            assert a.loss_at(k) == b.loss_at(k)


def test_calibration_save_is_byte_identical(calibration, reference_calibration, tmp_path):
    """The port's calibration of the reference's profiles and signatures: the
    same signatures, the same metadata but for ``source``, which names the
    package that measured; saved with the reference's metadata, the same bytes."""
    assert calibration.signatures == reference_calibration.signatures
    ours_meta, ref_meta = dict(calibration.meta), dict(reference_calibration.meta)
    assert ours_meta.pop("source").startswith("repro_torch.bridge dry-run")
    ref_meta.pop("source")
    assert ours_meta == ref_meta
    assert (bridge_profiles.NUM_CHIPS, bridge_profiles.PROFILE_SHAPE, bridge_profiles.STEPS_PER_EPOCH) == (
        256, "train_4k", 1000)
    ours = dataclasses.replace(calibration, meta=reference_calibration.meta)
    ours.save(str(tmp_path / "torch.json"))
    reference_calibration.save(str(tmp_path / "jax.json"))
    assert (tmp_path / "torch.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    loaded = Calibration.load(str(tmp_path / "jax.json"))
    assert loaded.signatures == reference_calibration.signatures
    assert {n: dataclasses.asdict(p) for n, p in loaded.profiles.items()} == {
        n: dataclasses.asdict(p) for n, p in reference_calibration.profiles.items()}


def test_build_calibration_without_profiles_saves_the_references_bytes(reference_calibration, tmp_path):
    """The roofline-derived family profiles and host rows equal the
    reference's with ``==``, and ``build_calibration()`` without profiles
    saves the reference's bytes once ``meta["source"]`` (which names the
    package that measured) is the reference's."""
    ours = bridge_profiles.derive_profiles()
    assert list(ours) == list(jprofiles.derive_profiles())
    assert _asdicts(ours.values()) == _asdicts(jprofiles.derive_profiles().values())
    assert _asdicts(bridge_profiles.bridge_profiles().values()) == _asdicts(jprofiles.bridge_profiles().values())
    assert bridge_profiles.bridge_host_table() == jprofiles.bridge_host_table()
    cal = build_calibration()
    assert cal.meta["source"].startswith("repro_torch.bridge dry-run")
    assert {k: v for k, v in cal.meta.items() if k != "source"} == {
        k: v for k, v in reference_calibration.meta.items() if k != "source"}
    dataclasses.replace(cal, meta=reference_calibration.meta).save(str(tmp_path / "torch.json"))
    reference_calibration.save(str(tmp_path / "jax.json"))
    assert (tmp_path / "torch.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_load_refuses_another_version(calibration, tmp_path):
    path = tmp_path / "calibration.json"
    calibration.save(str(path))
    payload = json.loads(path.read_text())
    payload["version"] += 1
    path.write_text(json.dumps(payload))
    with pytest.raises(ValueError, match="version"):
        Calibration.load(str(path))


# Twins of tests/test_bridge_differential.py on the port's calibration.


def _profiles(cal, sig):
    return [cal.profiles[name] for name in sig]


def test_history_prediction_matches_measurement(calibration):
    predictor = JCTPredictor(History.from_calibration(calibration))
    for sig, measured in calibration.signatures.items():
        got = predictor.predict_inflation(_profiles(calibration, sig))
        assert got == pytest.approx(measured, rel=HISTORY_TOLERANCE), sig


def test_history_prediction_matches_after_disk_roundtrip(calibration, tmp_path):
    path = str(tmp_path / "calibration.json")
    calibration.save(path)
    reloaded = Calibration.load(path)
    predictor = JCTPredictor(History.from_calibration(reloaded))
    for sig, measured in calibration.signatures.items():
        got = predictor.predict_inflation(_profiles(reloaded, sig))
        assert got == pytest.approx(measured, rel=HISTORY_TOLERANCE), sig


def test_analytic_model_within_documented_tolerance(calibration):
    worst = (0.0, None)
    for sig, measured in calibration.signatures.items():
        model = colocation.inflation_factor(_profiles(calibration, sig))
        dev = abs(model - measured) / measured
        worst = max(worst, (dev, sig))
        assert dev <= ANALYTIC_TOLERANCE, (sig, measured, model, dev)
    assert worst[0] > ANALYTIC_TOLERANCE / 10, worst


def test_predictor_trust_chain(calibration):
    """history -> calibrated table -> analytic model, in that order; both
    packages' calibrated tables are cleared afterwards."""
    sig = next(s for s in calibration.signatures if colocation.paper_measured_inflation(s) is None)
    profs = _profiles(calibration, sig)
    measured = calibration.signatures[sig]
    empty_h = History(seed_with_paper=False)
    predictor = JCTPredictor(empty_h)
    try:
        colocation.clear_measured()
        assert predictor.predict_inflation(profs) == colocation.inflation_factor(profs)
        assert calibration.register_ground_truth() == sum(
            colocation.paper_measured_inflation(s) is None for s in calibration.signatures)
        assert jcolo.registered_measurements() == {}  # the port keeps its own table
        assert predictor.predict_inflation(profs) == pytest.approx(measured, rel=HISTORY_TOLERANCE)
        empty_h.record(sig, 1.5)
        assert predictor.predict_inflation(profs) == 1.5
        history = calibration.install()
        assert history.get(sig) == pytest.approx(measured, rel=HISTORY_TOLERANCE)
    finally:
        colocation.clear_measured()
        jcolo.clear_measured()


def test_register_measured_validates():
    try:
        with pytest.raises(ValueError, match="no co-location"):
            colocation.register_measured(("solo",), 1.1)
        with pytest.raises(ValueError, match="< 1.0"):
            colocation.register_measured(("a", "b"), 0.9)
        assert colocation.registered_measurements() == {}
    finally:
        colocation.clear_measured()
        jcolo.clear_measured()


# ---------------------------------------------------------------- the cluster and core modules vs the reference


def _asdicts(profiles):
    return [dataclasses.asdict(p) for p in profiles]


def _reference(profiles):
    return [jjob.JobProfile(**dataclasses.asdict(p)) for p in profiles]


def _pool(name):
    pool = {"paper": paper_profiles, "lm": lm_profiles}[name]()
    hosted = {n: dataclasses.replace(p, **dict(zip(("cpu_util", "dram_util", "loader_util", "host_sens"),
                                                      HOST_PROFILES[n])))
              for n, p in pool.items()}
    return pool, hosted


def _sets(pool):
    names = sorted(pool)
    return [tuple(pool[n] for n in c) for k in range(1, len(names) + 1) for c in itertools.combinations(names, k)] + [
        (pool[names[0]],) * 5, (pool[names[0]], pool[names[1]], pool[names[0]])]


def test_profiles_equal_the_reference():
    assert _asdicts(paper_profiles().values()) == _asdicts(jjob.paper_profiles().values())
    assert _asdicts(lm_profiles().values()) == _asdicts(jjob.lm_profiles().values())
    assert HOST_PROFILES == jjob.HOST_PROFILES


@pytest.mark.parametrize("pool", ["paper", "lm"])
@pytest.mark.parametrize("host", [False, True])
def test_inflation_model_equals_the_reference(pool, host):
    """The analytic model, the signature, the paper's measured inflation and
    a predicted finish time on every subset of a pool (and repeats past 4)."""
    profiles = _pool(pool)[host]
    for s in _sets(profiles):
        r = _reference(s)
        assert colocation.inflation_factor(s) == jcolo.inflation_factor(r)
        assert colocation.gpu_inflation_factor(s) == jcolo.gpu_inflation_factor(r)
        assert colocation.host_contention_factor(s) == jcolo.host_contention_factor(r)
        assert colocation.combined_gpu_util(s) == jcolo.combined_gpu_util(r)
        assert colocation.combined_mem_util(s) == jcolo.combined_mem_util(r)
        assert colocation.combined_peak_mem(s) == jcolo.combined_peak_mem(r)
        assert colocation.epoch_hours_colocated(s[0], s[1:]) == jcolo.epoch_hours_colocated(r[0], r[1:])
        sig = colocation.set_signature(s)
        assert sig == jcolo.set_signature(r)
        assert colocation.paper_measured_inflation(sig) == jcolo.paper_measured_inflation(sig)


@pytest.mark.parametrize("pool", ["paper", "lm"])
def test_history_and_predictor_equal_the_reference(pool):
    """``History(seed_with_paper=True)`` and ``JCTPredictor.predict_inflation``
    (host-aware and host-blind), then the same after recording a measurement."""
    h, jh = History(seed_with_paper=True), JaxHistory(seed_with_paper=True)
    assert h.signatures() == jh.signatures() and len(h) == len(jh) == len(power.PAPER_COLOCATED)
    profiles = _pool(pool)[1]
    for aware in (True, False):
        p, jp = JCTPredictor(h, host_aware=aware), JaxJCTPredictor(jh, host_aware=aware)
        for s in _sets(_pool(pool)[0]) + _sets(profiles):
            assert p.predict_inflation(s) == jp.predict_inflation(_reference(s))
    assert (h.hits, h.misses) == (jh.hits, jh.misses)
    sig = colocation.set_signature(list(profiles.values())[:2])
    h.record(sig, 0.97)  # a measurement below 1 is recorded as it is
    jh.record(sig, 0.97)
    s = list(profiles.values())[:2]
    assert JCTPredictor(h).predict_inflation(s) == JaxJCTPredictor(jh).predict_inflation(_reference(s)) == 0.97
    job, jjob_ = Job(0, s[0], 0.0, 1e9, epochs_done=2.5), jjob.Job(0, _reference(s)[0], 0.0, 1e9, epochs_done=2.5)
    for width in (None, 2, 8):
        assert JCTPredictor(h).predict_finish(1.0, job, s, 1.1, width) == JaxJCTPredictor(jh).predict_finish(
            1.0, jjob_, _reference(s), 1.1, width)


def test_history_save_and_load_round_trip(tmp_path):
    """Measurements recorded after the paper's seed survive ``save``/``load``
    exactly, below 1.0 too; ``load`` of a missing file gives the paper's seed."""
    h = History()
    h.record(("internvl2-2b", "mamba2-370m"), 1.0123456789012345)
    h.record(("internvl2-2b", "mamba2-370m", "mamba2-370m"), 0.99)
    path = str(tmp_path / "h" / "history.json")
    h.save(path)
    back = History.load(path)
    assert back.signatures() == h.signatures()
    assert back.get(("mamba2-370m", "internvl2-2b"), count=False) == 1.0123456789012345
    assert History.load(str(tmp_path / "absent.json")).signatures() == History().signatures()


def test_power_models_equal_the_reference():
    assert power.PAPER_SINGLE == jpower.PAPER_SINGLE and power.PAPER_COLOCATED == jpower.PAPER_COLOCATED
    assert power.DVFS_GAMMA == jpower.DVFS_GAMMA
    for name, sku in power.sku_registry().items():
        ref = jpower.get_sku(name)
        assert (sku.name, sku.speed, sku.perf_per_watt) == (ref.name, ref.speed, ref.perf_per_watt)
        assert dataclasses.asdict(sku.power) == dataclasses.asdict(ref.power)
        for u in (-5.0, 0.0, 37.5, 100.0, 120.0):
            for f in (0.5, 0.8, 1.0):
                assert sku.power.node_power_at(u, f) == ref.power.node_power_at(u, f)
            assert sku.power.energy_kwh(u, 2.5) == ref.power.energy_kwh(u, 2.5)
    assert power.fleet_skus(7, [("v100", 0.5), ("a100", 0.3), ("tpuv5e", 0.2)]) == jpower.fleet_skus(
        7, [("v100", 0.5), ("a100", 0.3), ("tpuv5e", 0.2)])
    for job in power.PAPER_SINGLE:
        assert power.paper_energy_single(job) == jpower.paper_energy_single(job)
    for jobs in power.PAPER_COLOCATED:
        assert power.paper_energy_colocated(jobs) == jpower.paper_energy_colocated(jobs)
    with pytest.raises(KeyError, match="unknown GPU SKU"):
        power.get_sku("h100")


def test_scaling_equals_the_reference():
    for p in list(paper_profiles().values()) + [dataclasses.replace(lm_profiles()["lm-small"], min_gpus=2,
                                                                    max_gpus=16, cpu_util=25.0)]:
        r = _reference([p])[0]
        assert scaling.feasible_widths(p) == jscaling.feasible_widths(r)
        for n in (1, 2, 3, 8, 16):
            assert scaling.efficiency(p, n) == jscaling.efficiency(r, n)
            assert scaling.epoch_hours_at(p, n) == jscaling.epoch_hours_at(r, n)
            assert scaling.gpu_hours_per_epoch(p, n) == jscaling.gpu_hours_per_epoch(r, n)
            assert dataclasses.asdict(scaling.reprofile(p, n)) == dataclasses.asdict(jscaling.reprofile(r, n))
    with pytest.raises(ValueError):
        scaling.efficiency(p, 0)


def test_hardware_tables():
    """The TPU v5e table is the reference's, name for name; the H100 table
    holds the data-sheet values the kernel bounds use."""
    ref = {k: v for k, v in vars(jhw).items() if k.isupper()}
    assert {k: v for k, v in vars(hw).items() if k.isupper() and not k.startswith("H100_")} == ref
    assert (hw.H100_PEAK_FLOPS_BF16, hw.H100_HBM_BW, hw.H100_HBM_BYTES, hw.H100_POWER_LIMIT_W) == (
        989e12, 3.35e12, 80e9, 700.0)


def test_profiler_duty_against_the_peak_it_is_given():
    """The default peak is the reference's; the H100's gives a duty 197/989 as large."""
    job = analytic_job(paper_profiles()["vgg16"])
    stepper = TemporalStepper([job])
    f = job.bundle.flops_per_step
    ref_duty = EarlyStageProfiler({job.name: f}).profile_solo(stepper)[job.name].duty_cycle_pct
    h100 = EarlyStageProfiler.for_stepper(stepper, peak_flops=hw.H100_PEAK_FLOPS_BF16)
    assert h100.flops_per_step == {job.name: f}
    duty = h100.profile_solo(stepper)[job.name].duty_cycle_pct
    assert ref_duty == pytest.approx(paper_profiles()["vgg16"].gpu_util, rel=1e-12)
    assert duty == pytest.approx(ref_duty * jhw.PEAK_FLOPS_BF16 / hw.H100_PEAK_FLOPS_BF16, rel=1e-12)


def test_profiler_reads_no_flops_from_a_train_bundle():
    """A ``TrainBundle`` carries no FLOPs count, so ``for_stepper`` reports duty 0."""
    stepper = TemporalStepper([_job("mamba2-370m")], device="cpu")
    prof = EarlyStageProfiler.for_stepper(stepper)
    assert prof.flops_per_step == {"mamba2-370m": 0.0}
    assert prof.profile_solo(stepper, steps=1)["mamba2-370m"].duty_cycle_pct == 0.0


def test_evict_without_a_checkpoint_rolls_back_logically():
    job = analytic_job(paper_profiles()["alexnet"], steps_per_epoch=3)
    other = analytic_job(paper_profiles()["vgg16"], steps_per_epoch=3)
    stepper = TemporalStepper([job, other])
    for _ in range(5):
        stepper.step_round()
    assert stepper.evict("alexnet").step == 3
    assert [j.name for j in stepper.jobs] == ["vgg16"]
