"""Scheduler decision-audit log and the predictor-drift report.

Every placement decision records *what the scheduler believed* — the
candidate-set size and the predicted co-location inflation from the
``JCTPredictor`` trust chain (history -> calibrated table -> analytic
model) — alongside the inflation the placement *actually* experiences
(the simulator's ground truth for the placed set).  Job completion joins
the records back in: only decisions of completed jobs enter the drift
report, mirroring how a real fleet can only score predictions whose jobs
ran to the end.

The drift report turns the audit log into a calibration-error CDF per
model family, per node SKU, and per scheduler — the fleet-wide
generalization of the single H-hit-rate number from the calibration
bridge.  Baseline schedulers record their *implicit* prediction
(inflation 1.0: FIFO variants and Gandiva place as if sharing were free),
so the report also quantifies exactly how much reality the
energy-oblivious policies ignore.

Calibration error per decision: ``predicted / realized - 1`` (signed;
negative = the predictor was optimistic about sharing).  Exclusive
placements (degree 0) have zero error by construction and are counted but
excluded from the error statistics.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.obs.tables import ColumnTable

# calibration-error CDF bucket edges (absolute relative error)
CDF_EDGES = (0.01, 0.02, 0.05, 0.10, 0.20, 0.50, 1.00)


class DecisionAudit:
    """The decision/outcome log joined at job completion.

    ``decisions`` — one row per scheduler placement decision;
    ``completions`` — one row per finished job (JCT, wait, energy,
    undo/restart/resize counters, SLO outcome).  ``resolved`` marks the
    decision rows whose job completed; only those enter
    :func:`drift_report`.
    """

    def __init__(self):
        self.decisions = ColumnTable(
            (
                "t", "scheduler", "job_id", "family", "sku", "node_id",
                "width", "degree", "n_candidates", "freq", "reason",
                "predicted_inflation", "realized_inflation",
                "predicted_finish_h", "deadline_h",
            )
        )
        self.completions = ColumnTable(
            (
                "t", "job_id", "family", "jct_h", "jtt_h", "wait_h",
                "energy_kwh", "undo_count", "restart_count", "resize_count",
                "violated",
            )
        )
        self.resolved: List[bool] = []
        self._pending: Dict[int, List[int]] = {}  # job id -> decision rows

    def decision(
        self,
        t: float,
        scheduler: str,
        job,
        sku: str,
        node_id: int,
        width: int,
        degree: int,
        n_candidates: int,
        freq: float,
        predicted_inflation: float,
        realized_inflation: float,
        predicted_finish_h: float,
        reason: str = "queue",
    ) -> None:
        """Record one placement decision for ``job`` (a ``cluster.Job``).

        ``degree`` is the number of jobs already resident on the chosen
        GPUs (0 = exclusive); ``n_candidates`` the size of the candidate
        set the scheduler ranked (0 = not enumerated, e.g. the FIFO
        baselines); ``reason`` distinguishes the admission path (``queue``
        / ``narrow`` / ``pack`` ...).
        """
        row = len(self.resolved)
        self.decisions.append(
            t, scheduler, job.id, job.profile.name, sku, node_id,
            width, degree, n_candidates, freq, reason,
            predicted_inflation, realized_inflation,
            predicted_finish_h, job.deadline,
        )
        self.resolved.append(False)
        self._pending.setdefault(job.id, []).append(row)

    def on_complete(self, job, t: float) -> None:
        """Join ``job``'s completion back into its decision rows and
        record the completion outcome row."""
        for row in self._pending.pop(job.id, ()):
            self.resolved[row] = True
        self.completions.append(
            t, job.id, job.profile.name, job.jct(), job.jtt(),
            job.start_time - job.arrival, job.energy_kwh,
            job.undo_count, job.restart_count, job.resize_count,
            bool(t > job.deadline),
        )


def _err_stats(errors: List[float]) -> Dict[str, Any]:
    """Summary statistics of signed calibration errors: mean absolute
    error, signed bias, p50/p90/p99 of |err|, and the CDF histogram over
    ``CDF_EDGES`` (cumulative counts of |err| <= edge)."""
    n = len(errors)
    if n == 0:
        return {"n": 0}
    abs_sorted = sorted(abs(e) for e in errors)

    def pct(q: float) -> float:
        return abs_sorted[min(int(q * n), n - 1)]

    cdf = {}
    i = 0
    for edge in CDF_EDGES:
        while i < n and abs_sorted[i] <= edge:
            i += 1
        cdf[f"<={edge}"] = i
    return {
        "n": n,
        "mean_abs_err": sum(abs_sorted) / n,
        "bias": sum(errors) / n,
        "p50": pct(0.50),
        "p90": pct(0.90),
        "p99": pct(0.99),
        "max": abs_sorted[-1],
        "cdf": cdf,
    }


def _group_stats(groups: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Finalize per-group accumulators into report entries."""
    out = {}
    for key in sorted(groups):
        g = groups[key]
        entry = {"n_decisions": g["n"], "n_colocated": len(g["errors"])}
        if g["errors"]:
            entry.update(_err_stats(g["errors"]))
        out[key] = entry
    return out


def drift_report(audit: DecisionAudit) -> Dict[str, Any]:
    """Predictor-drift report over the resolved decision rows.

    Returns overall calibration-error statistics plus per-family,
    per-SKU, and per-scheduler breakdowns.  Deterministic: a function of
    the audit log alone (locked by the drift-determinism test).
    """
    cols = audit.decisions
    fam_col = cols.column("family")
    sku_col = cols.column("sku")
    sched_col = cols.column("scheduler")
    deg_col = cols.column("degree")
    pred_col = cols.column("predicted_inflation")
    real_col = cols.column("realized_inflation")

    overall_errors: List[float] = []
    by_family: Dict[str, Dict[str, Any]] = {}
    by_sku: Dict[str, Dict[str, Any]] = {}
    by_sched: Dict[str, Dict[str, Any]] = {}
    n_resolved = 0
    for row, done in enumerate(audit.resolved):
        if not done:
            continue
        n_resolved += 1
        err: Optional[float] = None
        if deg_col[row] > 0 and real_col[row] > 0:
            err = pred_col[row] / real_col[row] - 1.0
            overall_errors.append(err)
        for table, key in (
            (by_family, fam_col[row]),
            (by_sku, sku_col[row]),
            (by_sched, sched_col[row]),
        ):
            g = table.setdefault(key, {"n": 0, "errors": []})
            g["n"] += 1
            if err is not None:
                g["errors"].append(err)
    return {
        "n_decisions": len(audit.resolved),
        "n_resolved": n_resolved,
        "n_colocated": len(overall_errors),
        "overall": _err_stats(overall_errors),
        "by_family": _group_stats(by_family),
        "by_sku": _group_stats(by_sku),
        "by_scheduler": _group_stats(by_sched),
    }
