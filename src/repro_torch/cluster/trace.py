"""Production-like job traces for the simulator (§6.2 methodology).

Two generators:

  * ``generate_trace`` — the paper's synthetic mix (Poisson arrivals,
    uniform profile pool); unchanged semantics, used by the calibration
    benchmarks and golden tests;
  * ``generate_production_trace`` — a Philly/Helios-style cluster workload
    (Hu et al.; Jeon et al.): heavy-tailed log-normal durations, bursty
    Zipf-weighted tenant (VC) sessions, a small-job-dominated width mix,
    and failure-retry resubmissions.  Scales to 10k+ jobs and drives the
    ``benchmarks/scale_bench.py`` heterogeneous-fleet replay.

Traces are plain ``[(JobProfile, arrival_h, deadline_h)]`` lists either
way, and round-trip through CSV (``trace_to_csv`` / ``trace_from_csv``) so
external traces can be replayed.
"""

from __future__ import annotations

import csv
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cluster.job import (
    HOST_PROFILES,
    HOST_REF_WIDTH,
    Job,
    JobProfile,
    lm_profiles,
    paper_profiles,
)
from repro_torch.elastic import scaling


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    n_jobs: int = 100
    arrival_rate_per_hour: float = 2.0  # Poisson
    seed: int = 0
    # deadline tiers: (probability, slack factor over exclusive JCT);
    # slack inf = no SLO (paper: "some jobs may have no explicit SLO")
    deadline_tiers: Tuple[Tuple[float, float], ...] = (
        (0.2, 1.15),  # tight SLO
        (0.5, 2.0),  # relaxed (e.g. "within 12 hours" class)
        (0.3, math.inf),  # batch, no SLO
    )
    mix: str = "paper"  # "paper" (4 CV jobs) | "lm" | "mixed"
    diurnal: bool = False  # modulate arrivals day/night
    # fraction of jobs emitted as elastic (resizable between elastic_min
    # and elastic_max GPUs, re-referenced to a sampled start width)
    elastic_frac: float = 0.0
    elastic_min: int = 2
    elastic_max: int = 8
    elastic_widths: Tuple[int, ...] = (4, 8)  # sampled reference widths


def known_family_profiles() -> Dict[str, JobProfile]:
    """Every family a trace may reference by name: the paper's four CV
    jobs, the TPU-flavour LM stand-ins, and the bridge-calibrated model
    families (``repro_torch.bridge``, imported lazily: the configs package pulls
    jax, which pure-numpy trace consumers must not pay for)."""
    out = dict(paper_profiles())
    out.update(lm_profiles())
    from repro_torch.bridge import bridge_profiles

    out.update(bridge_profiles())
    return out


def resolve_family(name: str) -> JobProfile:
    """Profile for a family referenced by name; unknown names fail loudly
    (a typo'd trace must not surface as a bare KeyError mid-replay).

    Paper/lm families resolve without touching ``repro_torch.bridge`` — only a
    name outside the pure-numpy universe pays the configs/jax import.
    """
    cheap = dict(paper_profiles())
    cheap.update(lm_profiles())
    if name in cheap:
        return cheap[name]
    known = known_family_profiles()
    if name not in known:
        raise ValueError(
            f"unknown job family {name!r}; known families: {sorted(known)}"
        )
    return known[name]


def profile_pool(mix: str) -> List[JobProfile]:
    """Profile pool for a trace mix.

    ``paper`` | ``lm`` | ``mixed`` (paper+lm) | ``bridge`` (the calibrated
    model families) | ``all`` (everything) | or a comma-separated list of
    family names (e.g. ``"resnet50,qwen3-32b"``).  Unknown mixes and family
    names raise ``ValueError`` naming the known families.
    """
    if mix == "paper":
        return list(paper_profiles().values())
    if mix == "lm":
        return list(lm_profiles().values())
    if mix == "mixed":
        return list(paper_profiles().values()) + list(lm_profiles().values())
    if mix == "bridge":
        from repro_torch.bridge import bridge_profiles

        return [p for _, p in sorted(bridge_profiles().items())]
    if mix == "all":
        return [p for _, p in sorted(known_family_profiles().items())]
    return [resolve_family(name.strip()) for name in mix.split(",")]


# day/night arrival-intensity multipliers (day = first 12 h of each cycle)
DIURNAL_DAY = 1.5
DIURNAL_NIGHT = 0.5


def _diurnal_rate(base: float, t: float) -> float:
    return base * (DIURNAL_DAY if (t % 24.0) < 12.0 else DIURNAL_NIGHT)


def _next_arrival(rng: np.random.Generator, cfg: TraceConfig, t: float) -> float:
    """Next arrival time after ``t``.

    Diurnal arrivals are a *non-homogeneous* Poisson process: sampled by
    Lewis thinning against the peak rate, so the intensity is evaluated at
    the candidate arrival's own time (the old code sampled the rate at the
    PREVIOUS arrival, which let a night-time gap be drawn from the day-time
    rate across the boundary and vice versa).
    """
    if not cfg.diurnal:
        return t + float(rng.exponential(1.0 / cfg.arrival_rate_per_hour))
    # thinning bound = the intensity function's peak, by construction
    lam_max = cfg.arrival_rate_per_hour * max(DIURNAL_DAY, DIURNAL_NIGHT)
    while True:
        t += float(rng.exponential(1.0 / lam_max))
        if float(rng.random()) * lam_max <= _diurnal_rate(cfg.arrival_rate_per_hour, t):
            return t


def generate_trace(cfg: TraceConfig) -> List[Tuple[JobProfile, float, float]]:
    """Returns [(profile, arrival_h, deadline_h)]."""
    rng = np.random.Generator(np.random.PCG64(cfg.seed))
    pool = profile_pool(cfg.mix)
    out = []
    t = 0.0
    probs = np.array([p for p, _ in cfg.deadline_tiers])
    slacks = [s for _, s in cfg.deadline_tiers]
    for _ in range(cfg.n_jobs):
        t = _next_arrival(rng, cfg, t)
        prof = pool[int(rng.integers(len(pool)))]
        if cfg.elastic_frac > 0 and float(rng.random()) < cfg.elastic_frac:
            width = int(cfg.elastic_widths[int(rng.integers(len(cfg.elastic_widths)))])
            prof = scaling.reprofile(
                prof, width, min_gpus=cfg.elastic_min, max_gpus=cfg.elastic_max
            )
        slack = slacks[int(rng.choice(len(slacks), p=probs / probs.sum()))]
        deadline = t + slack * prof.base_jct_hours if math.isfinite(slack) else math.inf
        out.append((prof, t, deadline))
    return out


def load_into(sim, trace: Sequence[Tuple[JobProfile, float, float]]) -> None:
    """Submit every trace entry to ``sim`` as an arrival event."""
    for prof, arrival, deadline in trace:
        sim.add_job(prof, arrival, deadline)


def attach_host_profiles(
    trace: Sequence[Tuple[JobProfile, float, float]],
) -> List[Tuple[JobProfile, float, float]]:
    """Copy of ``trace`` with Synergy-style host-resource demand attached.

    Each profile whose family has a host characterization (the
    hand-calibrated ``HOST_PROFILES`` table for the paper/lm families, the
    roofline-derived bridge table for the calibrated model families —
    imported lazily so pure-numpy traces never pay the configs/jax cost)
    gains ``cpu_util``/``dram_util``/``loader_util`` scaled to its width
    (host demand tracks input throughput, referenced at
    ``HOST_REF_WIDTH``) plus its ``host_sens``.  Families with no host row
    stay host-blind; an already host-aware profile is left untouched.
    """
    table: Dict[str, Tuple[float, float, float, float]] = dict(HOST_PROFILES)
    bridge_loaded = False
    out: List[Tuple[JobProfile, float, float]] = []
    for prof, arrival, deadline in trace:
        if prof.has_host_demand:
            out.append((prof, arrival, deadline))
            continue
        row = table.get(prof.name)
        if row is None and not bridge_loaded:
            from repro_torch.bridge import bridge_host_table

            table.update(bridge_host_table())
            bridge_loaded = True
            row = table.get(prof.name)
        if row is None:
            out.append((prof, arrival, deadline))
            continue
        cpu, dram, loader, sens = row
        ratio = prof.n_gpus / HOST_REF_WIDTH
        prof = dataclasses.replace(
            prof,
            cpu_util=cpu * ratio,
            dram_util=dram * ratio,
            loader_util=loader * ratio,
            host_sens=sens,
        )
        out.append((prof, arrival, deadline))
    return out


# --------------------------------------------------------- production traces

# per-family A100 throughput multipliers (vs the V100 reference node):
# compute-bound families approach the fleet-default 2x; memory/input-bound
# families gain less — the spread that makes SKU-aware placement matter
A100_FAMILY_SPEEDUP: Dict[str, float] = {
    "alexnet": 1.5,  # input-pipeline bound at low duty cycle
    "resnet18": 1.7,
    "resnet50": 2.1,
    "vgg16": 2.2,
    "lm-small": 1.8,
    "lm-medium": 2.2,
    "lm-large": 2.4,  # dense matmul-dominated
    "lm-moe": 1.9,  # all-to-all bound
}


@dataclasses.dataclass(frozen=True)
class ProductionTraceConfig:
    """Philly/Helios-style workload knobs (defaults match the reported
    shapes: log-normal durations spanning minutes→days, bursty per-VC
    submission sessions, mostly-small GPU requests, ~6% failed attempts)."""

    n_jobs: int = 10_000
    seed: int = 0
    mix: str = "mixed"  # profile family pool (see ``profile_pool``)
    # --- arrival structure: Zipf-weighted tenants submitting in bursts
    arrival_rate_per_hour: float = 60.0  # fleet-wide mean job rate
    n_tenants: int = 16
    tenant_zipf_a: float = 1.2  # tenant weight ~ 1/rank^a
    burst_size_mean: float = 8.0  # geometric session length (jobs)
    burst_gap_h: float = 0.02  # mean intra-session gap (hours)
    diurnal: bool = True
    # --- durations: heavy-tailed log-normal total runtime (hours), mapped
    # onto each family's epoch structure by rescaling the epoch count
    duration_mu_ln_h: float = 0.0  # ln(hours): median e^mu = 1 h
    duration_sigma_ln_h: float = 1.6
    min_epochs: int = 2
    max_epochs: int = 500
    # --- width mix (Philly: 1-4 GPU jobs dominate) and elasticity
    width_probs: Tuple[Tuple[int, float], ...] = (
        (1, 0.30),
        (2, 0.25),
        (4, 0.25),
        (8, 0.20),
    )
    elastic_frac: float = 0.25  # widths may flex between w/2 and 2w
    # --- failures: a failed attempt wastes its partial run and is
    # resubmitted after a back-off (Philly's retry semantics)
    failure_frac: float = 0.06
    max_retries: int = 2
    retry_backoff_h: float = 0.25
    # --- SLOs (same tier semantics as TraceConfig)
    deadline_tiers: Tuple[Tuple[float, float], ...] = (
        (0.2, 1.15),
        (0.5, 2.0),
        (0.3, math.inf),
    )
    # emit per-family A100 speed overrides so heterogeneous fleets see a
    # perf/watt spread instead of one uniform speedup
    hetero_speeds: bool = True


def _tenant_weights(cfg: ProductionTraceConfig) -> np.ndarray:
    w = 1.0 / np.arange(1, cfg.n_tenants + 1, dtype=float) ** cfg.tenant_zipf_a
    return w / w.sum()


def generate_production_trace(
    cfg: ProductionTraceConfig,
) -> List[Tuple[JobProfile, float, float]]:
    """Returns [(profile, arrival_h, deadline_h)], arrival-sorted.

    Retried attempts of a failed job appear as separate entries: the failed
    attempt with its epoch count truncated at the failure point (the wasted
    work the cluster still burned energy on), the resubmission with the
    full epoch count and the original SLO.
    """
    rng = np.random.Generator(np.random.PCG64(cfg.seed))
    pool = profile_pool(cfg.mix)
    tenant_w = _tenant_weights(cfg)
    # each tenant runs a themed subset of families (Philly: VCs are
    # workload-homogeneous), with occasional off-theme submissions
    tenant_pools = [
        rng.choice(len(pool), size=min(3, len(pool)), replace=False)
        for _ in range(cfg.n_tenants)
    ]
    widths = [w for w, _ in cfg.width_probs]
    width_p = np.array([p for _, p in cfg.width_probs])
    width_p = width_p / width_p.sum()
    probs = np.array([p for p, _ in cfg.deadline_tiers])
    probs = probs / probs.sum()
    slacks = [s for _, s in cfg.deadline_tiers]

    burst_rate = cfg.arrival_rate_per_hour / cfg.burst_size_mean
    burst_cfg = TraceConfig(
        arrival_rate_per_hour=burst_rate, diurnal=cfg.diurnal
    )  # reuse the thinning sampler for burst starts
    out: List[Tuple[JobProfile, float, float]] = []
    t_burst = 0.0
    while len(out) < cfg.n_jobs:
        t_burst = _next_arrival(rng, burst_cfg, t_burst)
        tenant = int(rng.choice(cfg.n_tenants, p=tenant_w))
        # numpy's geometric is supported on {1, 2, ...} with mean 1/p, so
        # p = 1/burst_size_mean realizes the documented mean exactly (the
        # old ``1 + geometric`` draw was off by one: mean burst_size_mean+1)
        n_in_burst = int(rng.geometric(1.0 / cfg.burst_size_mean))
        t = t_burst
        for _ in range(n_in_burst):
            if len(out) >= cfg.n_jobs:
                break
            # ---- family: themed per tenant, 20% exploration
            if float(rng.random()) < 0.8:
                theme = tenant_pools[tenant]
                prof = pool[int(theme[rng.integers(len(theme))])]
            else:
                prof = pool[int(rng.integers(len(pool)))]
            # ---- duration: log-normal hours -> epoch count
            runtime_h = float(
                rng.lognormal(cfg.duration_mu_ln_h, cfg.duration_sigma_ln_h)
            )
            epochs = int(
                np.clip(
                    round(runtime_h / prof.epoch_hours),
                    cfg.min_epochs,
                    cfg.max_epochs,
                )
            )
            prof = dataclasses.replace(prof, epochs=epochs)
            # ---- width (and elasticity around it)
            w = int(widths[int(rng.choice(len(widths), p=width_p))])
            if cfg.elastic_frac > 0 and float(rng.random()) < cfg.elastic_frac:
                prof = scaling.reprofile(
                    prof, w, min_gpus=max(1, w // 2), max_gpus=min(8, 2 * w)
                )
            else:
                prof = scaling.reprofile(prof, w, min_gpus=w, max_gpus=w)
            if cfg.hetero_speeds and not prof.sku_speed:
                # bridge-calibrated families already carry their derived
                # per-SKU multipliers; only the paper/lm families take the
                # table here (and families in neither keep fleet defaults)
                prof = dataclasses.replace(
                    prof,
                    sku_speed=(("a100", A100_FAMILY_SPEEDUP[prof.name]),)
                    if prof.name in A100_FAMILY_SPEEDUP
                    else (),
                )
            # ---- SLO tier
            slack = slacks[int(rng.choice(len(slacks), p=probs))]
            deadline = (
                t + slack * prof.base_jct_hours if math.isfinite(slack) else math.inf
            )
            # ---- failure/retry structure
            fails = 0
            while (
                fails < cfg.max_retries and float(rng.random()) < cfg.failure_frac
            ):
                fails += 1
            t_attempt = t
            for k in range(fails):
                frac = float(rng.uniform(0.05, 0.8))
                wasted = max(1, int(frac * prof.epochs))
                out.append(
                    (dataclasses.replace(prof, epochs=wasted), t_attempt, math.inf)
                )
                t_attempt += wasted * prof.epoch_hours + cfg.retry_backoff_h
                if len(out) >= cfg.n_jobs:
                    break
            if len(out) < cfg.n_jobs:
                out.append((prof, t_attempt, deadline))
            t += float(rng.exponential(cfg.burst_gap_h))
    out.sort(key=lambda e: e[1])
    return out[: cfg.n_jobs]


# ------------------------------------------------------- inference requests


@dataclasses.dataclass(frozen=True)
class RequestStreamConfig:
    """Online-inference request stream knobs (``repro_torch.serve`` workload).

    Requests arrive in bursts (a burst ~ one upstream client batch or a
    traffic spike): burst *starts* follow the same non-homogeneous Poisson
    process as job arrivals (``_next_arrival``, diurnal day/night
    intensity), burst *sizes* are geometric with mean ``burst_size_mean``,
    and each burst targets one model drawn from a Zipf popularity law over
    ``models`` (rank 1 = most popular).  The stream is a plain
    ``[(model_name, arrival_h, n_requests)]`` list and round-trips through
    CSV (``request_stream_to_csv`` / ``request_stream_from_csv``).
    """

    n_requests: int = 100_000
    seed: int = 0
    # served model families, popularity rank order (Zipf weight 1/rank^a)
    models: Tuple[str, ...] = ("lm-small", "lm-medium", "resnet50")
    zipf_a: float = 1.1
    rate_per_hour: float = 40_000.0  # fleet-wide mean request rate
    burst_size_mean: float = 20.0  # mean requests per burst (geometric)
    diurnal: bool = True


def _model_weights(cfg: RequestStreamConfig) -> np.ndarray:
    w = 1.0 / np.arange(1, len(cfg.models) + 1, dtype=float) ** cfg.zipf_a
    return w / w.sum()


def generate_request_stream(
    cfg: RequestStreamConfig,
) -> List[Tuple[str, float, int]]:
    """Returns [(model_name, arrival_h, n_requests)], arrival-sorted.

    Exactly ``cfg.n_requests`` requests are emitted (the final burst is
    truncated), so replays are request-count-comparable across configs.
    """
    if not cfg.models:
        raise ValueError("RequestStreamConfig.models must name >= 1 family")
    rng = np.random.Generator(np.random.PCG64(cfg.seed))
    model_w = _model_weights(cfg)
    # burst starts arrive at rate/mean-size; reuse the thinning sampler
    burst_cfg = TraceConfig(
        arrival_rate_per_hour=cfg.rate_per_hour / cfg.burst_size_mean,
        diurnal=cfg.diurnal,
    )
    out: List[Tuple[str, float, int]] = []
    t = 0.0
    left = cfg.n_requests
    while left > 0:
        t = _next_arrival(rng, burst_cfg, t)
        model = cfg.models[int(rng.choice(len(cfg.models), p=model_w))]
        n = min(int(rng.geometric(1.0 / cfg.burst_size_mean)), left)
        out.append((model, t, n))
        left -= n
    return out


REQUEST_CSV_FIELDS = ("model", "arrival_h", "n_requests")


def request_stream_to_csv(
    stream: Sequence[Tuple[str, float, int]], path: str
) -> None:
    """Write a request stream in the replayable CSV schema (docs/traces.md)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(REQUEST_CSV_FIELDS)
        for model, arrival, n in stream:
            w.writerow([model, repr(arrival), n])


def request_stream_from_csv(path: str) -> List[Tuple[str, float, int]]:
    """Load a request stream written by ``request_stream_to_csv`` (or any
    external stream mapped onto the same 3-column schema)."""
    out: List[Tuple[str, float, int]] = []
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        missing = set(REQUEST_CSV_FIELDS) - set(reader.fieldnames or ())
        if missing:
            raise ValueError(
                f"request CSV {path} missing columns: {sorted(missing)}"
            )
        for row in reader:
            out.append(
                (row["model"], float(row["arrival_h"]), int(row["n_requests"]))
            )
    return out


# ----------------------------------------------------------------- CSV I/O

CSV_FIELDS = (
    "name",
    "epoch_hours",
    "epochs",
    "gpu_util",
    "mem_util",
    "peak_mem_util",
    "n_gpus",
    "min_gpus",
    "max_gpus",
    "scaling_c",
    "sku_speed",  # "a100:1.8|h100:2.5" ("" = fleet defaults)
    "arrival_h",
    "deadline_h",  # "inf" = no SLO
)

# optional host-demand columns (Synergy-style disaggregated resources):
# always written by ``trace_to_csv``; ``trace_from_csv`` defaults a missing
# column (pre-host CSVs) to 0.0 = host-blind, so old traces replay
# byte-identically
HOST_CSV_FIELDS = ("cpu_util", "dram_util", "loader_util", "host_sens")


def _encode_sku_speed(sku_speed: Tuple[Tuple[str, float], ...]) -> str:
    # repr, like every other float column: the round-trip must be lossless
    return "|".join(f"{n}:{s!r}" for n, s in sku_speed)


def _decode_sku_speed(text: str) -> Tuple[Tuple[str, float], ...]:
    if not text:
        return ()
    out = []
    for part in text.split("|"):
        name, _, val = part.partition(":")
        out.append((name, float(val)))
    return tuple(out)


def trace_to_csv(trace: Sequence[Tuple[JobProfile, float, float]], path: str) -> None:
    """Write a trace in the replayable CSV schema (see README)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(CSV_FIELDS + HOST_CSV_FIELDS)
        for prof, arrival, deadline in trace:
            w.writerow(
                [
                    prof.name,
                    repr(prof.epoch_hours),
                    prof.epochs,
                    repr(prof.gpu_util),
                    repr(prof.mem_util),
                    repr(prof.peak_mem_util),
                    prof.n_gpus,
                    prof.min_gpus,
                    prof.max_gpus,
                    repr(prof.scaling_c),
                    _encode_sku_speed(prof.sku_speed),
                    repr(arrival),
                    "inf" if math.isinf(deadline) else repr(deadline),
                    repr(prof.cpu_util),
                    repr(prof.dram_util),
                    repr(prof.loader_util),
                    repr(prof.host_sens),
                ]
            )


def trace_from_csv(path: str) -> List[Tuple[JobProfile, float, float]]:
    """Load a trace written by ``trace_to_csv`` (or any external trace
    mapped onto the same schema).

    The co-location machinery (history H, set signatures, memoized
    ground-truth inflation) keys on the family ``name``, so rows sharing a
    name must agree on the utilization columns; mixed-utilization rows
    under one name are rejected rather than silently cross-contaminating
    predictions.  Duration columns (``epochs``/``epoch_hours``/widths) may
    vary freely per row, as may the optional ``HOST_CSV_FIELDS`` (host
    demand scales with width, and the co-location signature extends itself
    with the host values when they are set): a CSV without the host
    columns loads with them at 0.0 — host-blind, byte-identical to the
    pre-host loader.
    """
    out: List[Tuple[JobProfile, float, float]] = []
    util_by_name: Dict[str, Tuple[float, float, float]] = {}
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        missing = set(CSV_FIELDS) - set(reader.fieldnames or ())
        if missing:
            raise ValueError(f"trace CSV {path} missing columns: {sorted(missing)}")
        for row in reader:
            utils = (
                float(row["gpu_util"]),
                float(row["mem_util"]),
                float(row["peak_mem_util"]),
            )
            prev = util_by_name.setdefault(row["name"], utils)
            if prev != utils:
                raise ValueError(
                    f"trace CSV {path}: rows named {row['name']!r} disagree "
                    f"on utilization columns ({prev} vs {utils}); names key "
                    f"the co-location model, so utilizations must match"
                )
            prof = JobProfile(
                name=row["name"],
                epoch_hours=float(row["epoch_hours"]),
                epochs=int(row["epochs"]),
                gpu_util=float(row["gpu_util"]),
                mem_util=float(row["mem_util"]),
                peak_mem_util=float(row["peak_mem_util"]),
                n_gpus=int(row["n_gpus"]),
                min_gpus=int(row["min_gpus"]),
                max_gpus=int(row["max_gpus"]),
                scaling_c=float(row["scaling_c"]),
                sku_speed=_decode_sku_speed(row["sku_speed"]),
                cpu_util=float(row.get("cpu_util") or 0.0),
                dram_util=float(row.get("dram_util") or 0.0),
                loader_util=float(row.get("loader_util") or 0.0),
                host_sens=float(row.get("host_sens") or 0.0),
            )
            out.append((prof, float(row["arrival_h"]), float(row["deadline_h"])))
    return out
