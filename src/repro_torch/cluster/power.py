"""Node power models, calibrated against the paper's measurements.

The V100 model reproduces EaCO's Tables 1-4 (8xV100 + 2x Xeon 6240 nodes):
a concave quadratic P(U) fitted by least squares over all ten measured
(utilization, power) points — four exclusive jobs (Table 1+2) and six
co-located sets (Table 3+4).  Concavity is physical: with hardware context
switching roughly one job's kernels occupy the SMs at any instant, so
marginal power flattens as utilization saturates (the paper's 4-job point:
96.6% util at 1944 W versus a linear extrapolation of ~2400 W).

The TPU v5e model follows the same functional form with the constants in
``repro_torch.roofline.hw`` (the reference's deployment target); utilization for
TPU jobs is the MFU-style duty cycle from the dry-run artifacts.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.roofline import hw

# DVFS power-law exponent: dynamic draw scales ~ f^gamma with the relative
# core frequency (cubic in the ideal V~f regime; 2.7 matches the slightly
# sub-cubic exponents measured on real GPUs, where voltage cannot track
# frequency all the way down the ladder)
DVFS_GAMMA = 2.7

# --- paper calibration data (Tables 1-4) -----------------------------------

# job profiles measured on an exclusive 8xV100 node
# name: (power_W, energy_kWh, jct_h, epoch_h, mem_avg, mem_max, gpu_avg, gpu_max)
PAPER_SINGLE: Dict[str, Tuple[float, ...]] = {
    "alexnet": (712, 24.73, 34.76, 0.39, 1.73, 4.21, 4.72, 11.0),
    "resnet18": (959, 33.69, 35.13, 0.39, 6.07, 14.63, 11.17, 27.29),
    "resnet50": (1330, 47.87, 36.01, 0.40, 22.29, 43.92, 36.61, 72.04),
    "vgg16": (1533, 55.38, 36.13, 0.40, 30.03, 51.29, 48.01, 81.5),
}

# co-located sets: (power_W, energy_kWh, avg_jct_h, avg_epoch_h,
#                   mem_avg, mem_max, gpu_avg, gpu_max)
PAPER_COLOCATED: Dict[Tuple[str, ...], Tuple[float, ...]] = {
    ("alexnet", "resnet50"): (1390, 50.93, 36.63, 0.407, 22.66, 46.25, 40.25, 76.67),
    ("alexnet", "vgg16"): (1506, 54.97, 36.51, 0.406, 31.26, 52.96, 55.16, 87.75),
    ("resnet18", "vgg16"): (1644, 60.84, 37.01, 0.411, 34.85, 52.54, 61.06, 93.46),
    ("alexnet", "resnet18", "resnet50"): (1541, 59.01, 38.28, 0.425, 27.77, 55.88, 52.24, 91.88),
    ("alexnet", "resnet18", "vgg16"): (1713, 65.55, 38.26, 0.425, 35.83, 52.75, 66.99, 93.96),
    # Table 3 reports "-" for the 4-way epoch time (switching was no longer
    # sequential); 0.4887 is derived from its measured avg JCT:
    # 44.21 h / 35.51 h (mean single JCT) x 0.3925 h (mean single epoch).
    ("alexnet", "resnet18", "resnet50", "vgg16"): (1944, 93.66, 44.21, 0.4887, 43.46, 52.54, 96.64, 100.0),
}


def _fit_quadratic() -> Tuple[float, float, float]:
    """Least-squares concave quadratic P(U) over the 10 measured points."""
    pts: List[Tuple[float, float]] = []
    for vals in PAPER_SINGLE.values():
        pts.append((vals[6], vals[0]))
    for vals in PAPER_COLOCATED.values():
        pts.append((vals[6], vals[0]))
    u = np.array([p[0] for p in pts])
    p = np.array([p[1] for p in pts])
    A = np.stack([np.ones_like(u), u, u * u], axis=1)
    coef, *_ = np.linalg.lstsq(A, p, rcond=None)
    return float(coef[0]), float(coef[1]), float(coef[2])


@dataclasses.dataclass(frozen=True)
class PowerModel:
    """P(U) = a + b*U + c*U^2 (clamped at the calibrated peak), plus node
    housekeeping states."""

    a: float
    b: float
    c: float
    idle_w: float  # powered-on, no residents
    sleep_w: float  # low-power state (EaCO's consolidation payoff)
    max_util: float = 100.0

    def node_power(self, gpu_util: float) -> float:
        """Node draw (W) at ``gpu_util`` percent, full clock."""
        u = min(max(gpu_util, 0.0), self.max_util)
        return self.a + self.b * u + self.c * u * u

    def node_power_at(self, gpu_util: float, freq: float = 1.0) -> float:
        """Node draw (W) at ``gpu_util`` percent with the accelerators
        clocked at relative frequency ``freq`` (top step == 1.0).

        The DVFS law: the *dynamic* component (draw above idle) scales with
        ``freq ** DVFS_GAMMA`` while the static/housekeeping component does
        not.  At ``freq >= 1.0`` this returns ``node_power`` bit-for-bit —
        the calibration invariant every frequency-unaware simulation relies
        on."""
        base = self.node_power(gpu_util)
        if freq >= 1.0:
            return base
        dynamic = max(base - self.idle_w, 0.0)
        return self.idle_w + dynamic * freq**DVFS_GAMMA

    def energy_kwh(self, gpu_util: float, hours: float) -> float:
        """Energy (kWh) of ``hours`` at ``gpu_util`` percent, full clock."""
        return self.node_power(gpu_util) * hours / 1000.0


@functools.lru_cache(maxsize=None)
def v100_power_model() -> PowerModel:
    a, b, c = _fit_quadratic()
    return PowerModel(a=a, b=b, c=c, idle_w=a, sleep_w=75.0)


def scaled_power_model(base: PowerModel, scale: float) -> PowerModel:
    """A node whose draw is ``scale`` x ``base`` at every utilization (same
    concave shape; idle/sleep housekeeping scales with the platform)."""
    return PowerModel(
        a=base.a * scale,
        b=base.b * scale,
        c=base.c * scale,
        idle_w=base.idle_w * scale,
        sleep_w=base.sleep_w * scale,
        max_util=base.max_util,
    )


@functools.lru_cache(maxsize=None)
def a100_power_model() -> PowerModel:
    """Stylized 8xA100 node: ~1.5x the V100 node's draw at equal duty cycle
    (8x400 W GPUs + beefier host vs 8x300 W), with ~2x the throughput — the
    perf/watt gap (~1.33x) that makes heterogeneous placement interesting."""
    return scaled_power_model(v100_power_model(), 1.5)


# --- GPU SKUs (heterogeneous fleets) ----------------------------------------


@dataclasses.dataclass(frozen=True)
class GPUSku:
    """A node hardware generation: calibrated power model + a fleet-default
    throughput multiplier versus the V100 reference node (job families can
    override it per SKU via ``JobProfile.sku_speed``)."""

    name: str
    speed: float  # epoch-time divisor vs the V100 reference node
    power: PowerModel

    @property
    def perf_per_watt(self) -> float:
        """Relative work per joule at full duty cycle (V100 == 1.0-ish);
        the quantity energy-aware placement trades across the fleet."""
        return self.speed / (self.power.node_power(100.0) / 1000.0)


@functools.lru_cache(maxsize=None)
def sku_registry() -> Dict[str, GPUSku]:
    return {
        "v100": GPUSku("v100", speed=1.0, power=v100_power_model()),
        "a100": GPUSku("a100", speed=2.0, power=a100_power_model()),
        # 8-chip v5e host: modestly faster than the V100 reference node for
        # LM steps at a far lower envelope — the fleet's perf/watt outlier.
        # Bridge-calibrated families carry per-family overrides
        # (JobProfile.sku_speed) interpolated by how compute-bound they are.
        "tpuv5e": GPUSku("tpuv5e", speed=1.3, power=tpu_v5e_power_model()),
    }


def get_sku(name: str) -> GPUSku:
    """Registered ``GPUSku`` for ``name`` (KeyError names the known set)."""
    try:
        return sku_registry()[name]
    except KeyError:
        raise KeyError(
            f"unknown GPU SKU {name!r}; known: {sorted(sku_registry())}"
        ) from None


def fleet_skus(n_nodes: int, mix: Sequence[Tuple[str, float]]) -> Tuple[str, ...]:
    """Deterministic per-node SKU assignment from fractional ``mix`` (e.g.
    ``[("v100", 0.5), ("a100", 0.5)]``), interleaved round-robin by weight so
    every contiguous slice of the fleet is representative."""
    names = [n for n, _ in mix]
    weights = np.array([w for _, w in mix], dtype=float)
    if (weights <= 0).any():
        raise ValueError(f"non-positive weight in mix {mix}")
    for n in names:
        get_sku(n)  # validate early
    quota = weights / weights.sum() * n_nodes
    filled = np.zeros(len(names))
    out: List[str] = []
    for _ in range(n_nodes):
        # largest-remainder interleave: pick the most under-filled SKU
        i = int(np.argmax(quota - filled))
        out.append(names[i])
        filled[i] += 1.0
    return tuple(out)


def tpu_v5e_power_model(chips_per_node: int = hw.CHIPS_PER_HOST) -> PowerModel:
    """Same concave form, v5e constants: interpolates idle->peak with a mild
    saturation matched to the V100 fit's curvature ratio."""
    idle = hw.HOST_IDLE_W + chips_per_node * hw.CHIP_IDLE_W
    peak = hw.HOST_PEAK_W + chips_per_node * hw.CHIP_PEAK_W
    # quadratic through (0, idle) and (100, peak) with the V100 curvature
    # ratio c*100/b preserved
    _, bv, cv = _fit_quadratic()
    ratio = cv * 100.0 / bv  # < 0 (concave)
    b = (peak - idle) / (100.0 * (1 + ratio))
    c = b * ratio / 100.0
    return PowerModel(a=idle, b=b, c=c, idle_w=idle, sleep_w=0.15 * idle)


def paper_energy_single(job: str) -> float:
    """Measured exclusive-run energy (kWh) of a paper job (Table 1)."""
    return PAPER_SINGLE[job][1]


def paper_energy_colocated(jobs: Tuple[str, ...]) -> float:
    """Measured co-located energy (kWh) of a paper set (Table 3)."""
    return PAPER_COLOCATED[tuple(sorted(jobs))][1]
