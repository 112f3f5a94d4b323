"""Dry-run co-location calibration: measure inflation, emit calibration.json.

The measurement path is the SAME executor a real deployment profiles with —
``TemporalStepper`` round-robin interleaving observed by the
``EarlyStageProfiler`` — but each job carries an ``AnalyticBundle`` instead
of a jitted train step, so a full 2-/3-/4-way sweep over every model family
runs in milliseconds on a CPU-only CI machine.

Outputs a versioned ``Calibration``:

  * ``profiles``   — the roofline-derived ``JobProfile`` per family,
  * ``signatures`` — measured epoch-time inflation per co-location set
    (sorted family names joined with ``|`` on disk, the History format),

with ``save``/``load`` JSON round-tripping, ``seed_history`` to grow H, and
``install`` to also register the measurements as simulator ground truth via
``cluster.colocation.register_measured``.

Tolerances (locked by ``tests/test_bridge_differential.py``):

  * ``HISTORY_TOLERANCE`` — a calibration-seeded ``History`` /
    ``JCTPredictor`` must reproduce the stepper-measured inflation exactly
    (the measurement IS the history entry; only float round-trip noise is
    allowed);
  * ``ANALYTIC_TOLERANCE`` — the analytic fallback model
    (``cluster.colocation.inflation_factor``) must stay within 20% relative
    of the dry-run measurement on every calibrated signature (the paper's
    §3 trends are coarse: degree steps of ~3.5/8/20% against a contention
    model that also prices HBM working sets; the measured worst case across
    the default 65-signature sweep is ~13%).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.cluster import colocation
from repro_torch.cluster.job import JobProfile
from repro_torch.colocation.profiler import EarlyStageProfiler
from repro_torch.colocation.stepper import AnalyticBundle, ColocatedJob, TemporalStepper
from repro_torch.roofline import hw

HISTORY_TOLERANCE = 1e-9  # calibrated-history prediction vs measurement
ANALYTIC_TOLERANCE = 0.20  # analytic-model fallback vs measurement

CALIBRATION_VERSION = 1

Signature = Tuple[str, ...]


# --------------------------------------------------------------- measurement


def analytic_job(
    profile: JobProfile,
    steps_per_epoch: int = 8,
    target_epochs: int = 1_000_000,
) -> ColocatedJob:
    """A stepper job driven by the profile's own analytic step model.

    ``solo_step_s`` re-derives the per-step seconds from the profile's epoch
    time (1000-step epochs, the ``bridge.profiles`` convention), and the
    FLOPs count makes the profiler's MFU-style duty agree with the profile.
    """
    solo_step_s = profile.epoch_hours * 3600.0 / 1000.0
    bundle = AnalyticBundle(
        name=profile.name,
        solo_step_s=solo_step_s,
        duty_cycle_pct=profile.gpu_util,
        mem_util_pct=profile.mem_util,
        flops_per_step=profile.gpu_util / 100.0 * solo_step_s * hw.PEAK_FLOPS_BF16,
    )
    return ColocatedJob(
        name=profile.name,
        bundle=bundle,
        pipeline=None,  # never touched on the dry-run path
        steps_per_epoch=steps_per_epoch,
        target_epochs=target_epochs,
    )


def measure_signature(
    profiles: Sequence[JobProfile], rounds: int = 3, solo_steps: int = 3
) -> float:
    """Set-level inflation for one co-location set: solo-profile every
    member, observe the co-located round-robin, average the per-job
    inflations (the convention behind the paper's Table 3 epoch column)."""
    if len(profiles) <= 1:
        return 1.0
    stepper = TemporalStepper([analytic_job(p) for p in profiles])
    profiler = EarlyStageProfiler.for_stepper(stepper)
    profiler.profile_solo(stepper, steps=solo_steps)
    obs = profiler.observe(stepper, rounds=rounds)
    inflations = [o.inflation_vs_solo for o in obs.values() if o.inflation_vs_solo]
    return sum(inflations) / len(inflations)


def default_signatures(names: Sequence[str]) -> List[Signature]:
    """The calibrated sweep: every 2-way pair, plus sliding 3-way and 4-way
    windows over the name-sorted family list (deterministic, >= 20 sets for
    >= 5 families)."""
    names = sorted(names)
    sigs: List[Signature] = [tuple(sorted(p)) for p in itertools.combinations(names, 2)]
    n = len(names)
    for k in (3, 4):
        for i in range(n):
            win = tuple(sorted(names[(i + j) % n] for j in range(k)))
            if len(set(win)) == k and win not in sigs:
                sigs.append(win)
    return sigs


# --------------------------------------------------------------- calibration


@dataclasses.dataclass
class Calibration:
    """Versioned bridge output: family profiles + measured signatures."""

    profiles: Dict[str, JobProfile]
    signatures: Dict[Signature, float]
    version: int = CALIBRATION_VERSION
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    # -- consumers ---------------------------------------------------------

    def seed_history(self, history) -> int:
        """Grow a ``core.history.History`` with the measured signatures."""
        return history.seed_from(self.signatures)

    def register_ground_truth(self) -> int:
        """Register every non-paper signature as simulator ground truth
        (``cluster.colocation.register_measured``)."""
        n = 0
        for sig, infl in self.signatures.items():
            if colocation.paper_measured_inflation(sig) is None:
                colocation.register_measured(sig, infl)
                n += 1
        return n

    def install(self):
        """Register ground truth and return a paper+calibration-seeded
        ``History`` — the one-call setup for model-family replays."""
        from repro_torch.core.history import History

        self.register_ground_truth()
        return History.from_calibration(self)

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        """Write the versioned calibration artifact (sorted, stable JSON
        — the checked-in ``benchmarks/artifacts/calibration.json``)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {
            "version": self.version,
            "meta": self.meta,
            "profiles": {
                name: {
                    **{
                        k: v
                        for k, v in dataclasses.asdict(p).items()
                        if k != "sku_speed"
                    },
                    "sku_speed": [[n, s] for n, s in p.sku_speed],
                }
                for name, p in sorted(self.profiles.items())
            },
            "signatures": {
                "|".join(sig): infl for sig, infl in sorted(self.signatures.items())
            },
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "Calibration":
        """Load a calibration artifact, refusing version mismatches."""
        with open(path) as f:
            payload = json.load(f)
        if payload.get("version") != CALIBRATION_VERSION:
            raise ValueError(
                f"calibration {path} has version {payload.get('version')!r}; "
                f"this build reads version {CALIBRATION_VERSION} — regenerate "
                f"with: PYTHONPATH=src:. python benchmarks/bridge_bench.py"
            )
        profiles = {}
        for name, row in payload["profiles"].items():
            row = dict(row)
            row["sku_speed"] = tuple((n, float(s)) for n, s in row["sku_speed"])
            profiles[name] = JobProfile(**row)
        signatures = {
            tuple(k.split("|")): float(v) for k, v in payload["signatures"].items()
        }
        return cls(
            profiles=profiles,
            signatures=signatures,
            version=payload["version"],
            meta=payload.get("meta", {}),
        )


def build_calibration(
    profiles: Optional[Dict[str, JobProfile]] = None,
    signatures: Optional[Iterable[Signature]] = None,
    rounds: int = 3,
) -> Calibration:
    """The full pipeline: derive family profiles, measure every signature
    through the dry-run stepper, return the versioned ``Calibration``."""
    from repro_torch.bridge.profiles import (
        NUM_CHIPS,
        PROFILE_SHAPE,
        STEPS_PER_EPOCH,
        bridge_profiles,
    )

    profiles = dict(profiles if profiles is not None else bridge_profiles())
    sigs = list(signatures if signatures is not None else default_signatures(profiles))
    measured: Dict[Signature, float] = {}
    for sig in sigs:
        missing = [n for n in sig if n not in profiles]
        if missing:
            raise ValueError(
                f"signature {sig} references unknown families {missing}; "
                f"known: {sorted(profiles)}"
            )
        measured[tuple(sorted(sig))] = measure_signature(
            [profiles[n] for n in sig], rounds=rounds
        )
    return Calibration(
        profiles=profiles,
        signatures=measured,
        meta={
            "source": "repro_torch.bridge dry-run (TemporalStepper + EarlyStageProfiler)",
            "profile_cell": f"{PROFILE_SHAPE} @ {NUM_CHIPS} chips",
            "steps_per_epoch": STEPS_PER_EPOCH,
            "n_families": len(profiles),
            "n_signatures": len(measured),
        },
    )


def load_calibration(path: Optional[str] = None) -> Calibration:
    """Load the checked-in artifact (default:
    ``benchmarks/artifacts/calibration.json``)."""
    if path is None:
        path = os.path.join(
            os.path.dirname(__file__),
            "..",
            "..",
            "..",
            "benchmarks",
            "artifacts",
            "calibration.json",
        )
    return Calibration.load(os.path.abspath(path))
