"""Differential tests for the sim-to-real calibration bridge.

The bridge's contract (tolerances defined and documented in
``repro_torch.bridge.calibrate``):

  * a calibration-seeded ``History`` / ``JCTPredictor`` reproduces the
    stepper-measured inflation for EVERY calibrated signature within
    ``HISTORY_TOLERANCE`` (the measurement IS the history entry — only
    float round-trip noise is tolerated, including across a save/load
    cycle of ``calibration.json``);
  * the analytic fallback model (``cluster.colocation.inflation_factor``)
    stays within ``ANALYTIC_TOLERANCE`` relative of the measurement on
    every calibrated signature;
  * registered measurements become simulator ground truth, so a replay's
    ``true_inflation`` equals the calibration for those sets;
  * re-measuring any signature through the dry-run stepper is
    deterministic and reproduces the stored value.
"""

import pytest

from repro_torch.bridge import (
    ANALYTIC_TOLERANCE,
    HISTORY_TOLERANCE,
    Calibration,
    build_calibration,
    measure_signature,
)
from repro_torch.cluster import colocation
from repro_torch.cluster.simulator import SimConfig, Simulator
from repro_torch.core.eaco import EaCO
from repro_torch.core.history import History
from repro_torch.core.predictor import JCTPredictor


@pytest.fixture(scope="module")
def calibration():
    return build_calibration()


def _profiles(cal, sig):
    return [cal.profiles[name] for name in sig]


def test_acceptance_floor(calibration):
    """The issue's acceptance criteria: >= 8 families profiled, >= 20
    non-paper signatures measured and seedable into History."""
    assert len(calibration.profiles) >= 8
    non_paper = [
        sig
        for sig in calibration.signatures
        if colocation.paper_measured_inflation(sig) is None
    ]
    assert len(non_paper) >= 20
    h = History(seed_with_paper=True)
    added = calibration.seed_history(h)
    assert added >= 20
    assert len(h) >= 20 + len(colocation.PAPER_COLOCATED)


def test_history_prediction_matches_measurement(calibration):
    """Tier-1 trust: calibrated H serves the measured inflation exactly."""
    predictor = JCTPredictor(History.from_calibration(calibration))
    for sig, measured in calibration.signatures.items():
        got = predictor.predict_inflation(_profiles(calibration, sig))
        assert got == pytest.approx(measured, rel=HISTORY_TOLERANCE), sig


def test_history_prediction_matches_after_disk_roundtrip(calibration, tmp_path):
    """The same differential holds through calibration.json persistence."""
    path = str(tmp_path / "calibration.json")
    calibration.save(path)
    reloaded = Calibration.load(path)
    predictor = JCTPredictor(History.from_calibration(reloaded))
    for sig, measured in calibration.signatures.items():
        got = predictor.predict_inflation(_profiles(reloaded, sig))
        assert got == pytest.approx(measured, rel=HISTORY_TOLERANCE), sig


def test_analytic_model_within_documented_tolerance(calibration):
    """Tier-3 trust: the analytic co-location model tracks the dry-run
    measurement within ANALYTIC_TOLERANCE on every calibrated signature."""
    worst = (0.0, None)
    for sig, measured in calibration.signatures.items():
        model = colocation.inflation_factor(_profiles(calibration, sig))
        dev = abs(model - measured) / measured
        worst = max(worst, (dev, sig))
        assert dev <= ANALYTIC_TOLERANCE, (sig, measured, model, dev)
    # the tolerance is tight, not vacuous: the sweep's worst case uses a
    # real fraction of it (guards against the model and ground truth
    # silently becoming the same formula)
    assert worst[0] > ANALYTIC_TOLERANCE / 10, worst


def test_remeasurement_is_deterministic(calibration):
    """Dry-run measurements are pure: re-running the stepper reproduces
    the stored calibration value bit-for-bit."""
    for sig in list(calibration.signatures)[:8]:
        profs = _profiles(calibration, sig)
        a = measure_signature(profs)
        b = measure_signature(profs)
        assert a == b == calibration.signatures[sig], sig


def test_registered_measurements_are_simulator_ground_truth(calibration):
    """After install(), a replay runs ON the calibrated inflations: the
    simulator's true_inflation matches the measurement for every
    calibrated signature (no prediction-noise perturbation)."""
    try:
        history = calibration.install()
        sim = Simulator(SimConfig(n_nodes=2, seed=0), EaCO(history=history))
        for sig, measured in calibration.signatures.items():
            got = sim.true_inflation(_profiles(calibration, sig))
            assert got == pytest.approx(measured, rel=HISTORY_TOLERANCE), sig
    finally:
        colocation.clear_measured()


def test_predictor_trust_chain(calibration):
    """history -> calibrated table -> analytic model, in that order."""
    sig = next(
        s
        for s in calibration.signatures
        if colocation.paper_measured_inflation(s) is None
    )
    profs = _profiles(calibration, sig)
    measured = calibration.signatures[sig]
    empty_h = History(seed_with_paper=False)
    predictor = JCTPredictor(empty_h)
    try:
        # tier 3: nothing measured anywhere -> analytic model
        colocation.clear_measured()
        assert predictor.predict_inflation(profs) == colocation.inflation_factor(profs)
        # tier 2: registered calibration fills the history miss
        calibration.register_ground_truth()
        assert predictor.predict_inflation(profs) == pytest.approx(
            measured, rel=HISTORY_TOLERANCE
        )
        # tier 1: an online observation beats the offline calibration
        empty_h.record(sig, 1.5)
        assert predictor.predict_inflation(profs) == 1.5
    finally:
        colocation.clear_measured()


def test_register_measured_validates():
    with pytest.raises(ValueError, match="no co-location"):
        colocation.register_measured(("solo",), 1.1)
    with pytest.raises(ValueError, match="< 1.0"):
        colocation.register_measured(("a", "b"), 0.9)
