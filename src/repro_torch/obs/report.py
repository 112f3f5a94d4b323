"""Human-readable replay report over results + telemetry.

:func:`render_report` is the text backend behind ``tools/replay_report.py``:
headline fleet metrics, the predictor-drift tables (per family / SKU /
scheduler with the calibration-error CDF), power-cap enforcer activity,
elastic-plan outcomes, and — when profiling was armed — the event-loop
wall-time breakdown.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

# headline results() scalars shown first, in this order, with units
_HEADLINE = (
    ("jobs_completed", "", 0),
    ("makespan_h", "h", 2),
    ("avg_jct_h", "h", 3),
    ("p99_jct_h", "h", 3),
    ("energy_kwh", "kWh", 1),
    ("energy_per_job_kwh", "kWh", 3),
    ("avg_active_nodes", "", 2),
    ("peak_power_w", "W", 0),
    ("slo_violations", "", 0),
    ("undo_count", "", 0),
)


def _fmt(v: Any, nd: int) -> str:
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, float):
        return f"{v:,.{nd}f}"
    if isinstance(v, int):
        return f"{v:,}"
    return str(v)


def _table(header: List[str], rows: List[List[str]]) -> List[str]:
    widths = [len(h) for h in header]
    for r in rows:
        for i, cell in enumerate(r):
            widths[i] = max(widths[i], len(cell))
    out = ["  ".join(h.ljust(w) for h, w in zip(header, widths)).rstrip()]
    out.append("  ".join("-" * w for w in widths))
    for r in rows:
        out.append("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
    return out


def _drift_rows(groups: Dict[str, Dict[str, Any]]) -> List[List[str]]:
    rows = []
    for key, g in groups.items():
        if g.get("n"):
            rows.append(
                [
                    key,
                    str(g["n_decisions"]),
                    str(g["n_colocated"]),
                    f"{g['mean_abs_err']:.4f}",
                    f"{g['bias']:+.4f}",
                    f"{g['p90']:.4f}",
                    f"{g['p99']:.4f}",
                ]
            )
        else:
            rows.append([key, str(g["n_decisions"]), "0", "-", "-", "-", "-"])
    return rows


def render_report(
    results: Dict[str, Any], hub=None, title: str = "replay report"
) -> str:
    """Render the replay report as plain text.

    ``results`` is the ``Simulator.results()`` dict; ``hub`` (optional)
    adds telemetry coverage, drift tables, cap/elastic activity, and the
    event-loop profile section when present.
    """
    lines: List[str] = [title, "=" * len(title), ""]

    lines.append("headline metrics")
    lines.append("----------------")
    shown = set()
    for key, unit, nd in _HEADLINE:
        if key in results:
            shown.add(key)
            val = _fmt(results[key], nd)
            lines.append(f"  {key:<24} {val}{(' ' + unit) if unit else ''}")
    rest = [
        k for k in sorted(results)
        if k not in shown and isinstance(results[k], (int, float))
    ]
    for key in rest:
        lines.append(f"  {key:<24} {_fmt(results[key], 4)}")
    lines.append("")

    if hub is not None:
        counts = hub.counts()
        total = sum(counts.values())
        lines.append(f"telemetry coverage ({total:,} rows)")
        lines.append("------------------")
        for name in sorted(counts):
            if counts[name]:
                lines.append(f"  {name:<16} {counts[name]:,}")
        lines.append("")

        if hub.audit is not None:
            drift = hub.drift_report()
            lines.append("predictor drift")
            lines.append("---------------")
            lines.append(
                f"  decisions={drift['n_decisions']:,}"
                f"  resolved={drift['n_resolved']:,}"
                f"  co-located={drift.get('n_colocated', 0):,}"
            )
            overall = drift.get("overall", {})
            if overall.get("n"):
                lines.append(
                    f"  overall |err|: mean={overall['mean_abs_err']:.4f}"
                    f"  bias={overall['bias']:+.4f}"
                    f"  p50={overall['p50']:.4f}"
                    f"  p90={overall['p90']:.4f}"
                    f"  p99={overall['p99']:.4f}"
                )
                cdf = overall["cdf"]
                n = overall["n"]
                lines.append(
                    "  calibration CDF: "
                    + "  ".join(
                        f"{edge}:{100.0 * cnt / n:.0f}%"
                        for edge, cnt in cdf.items()
                    )
                )
            header = ["group", "dec", "coloc", "|err|", "bias", "p90", "p99"]
            for section in ("by_family", "by_sku", "by_scheduler"):
                groups = drift.get(section, {})
                if groups:
                    lines.append("")
                    lines.append(f"  {section.replace('_', ' ')}:")
                    for row in _table(header, _drift_rows(groups)):
                        lines.append("  " + row)
            lines.append("")

        if len(hub.cap_actions):
            actions: Dict[str, int] = {}
            for a in hub.cap_actions.column("action"):
                actions[a] = actions.get(a, 0) + 1
            lines.append("power-cap activity")
            lines.append("------------------")
            for a in sorted(actions):
                lines.append(f"  {a:<12} {actions[a]:,}")
            lines.append("")

        if len(hub.plans):
            issued = sum(1 for v in hub.plans.column("issued") if v)
            lines.append("elastic plans")
            lines.append("-------------")
            lines.append(f"  proposed={len(hub.plans):,}  issued={issued:,}")
            lines.append("")

    profile: Optional[Dict[str, Any]] = results.get("profile")
    if profile is None and hub is not None and hub.profiler is not None:
        profile = hub.profiler.summary()
    if profile:
        lines.append(
            f"event-loop profile ({profile['events_total']:,} events,"
            f" {profile['wall_s_total']:.3f}s wall)"
        )
        lines.append("------------------")
        header = ["kind", "count", "wall_s", "mean_us"]
        rows = [
            [kind, f"{g['count']:,}", f"{g['wall_s']:.4f}", f"{g['mean_us']:.1f}"]
            for kind, g in sorted(
                profile["by_kind"].items(),
                key=lambda kv: -kv[1]["wall_s"],
            )
        ]
        for row in _table(header, rows):
            lines.append("  " + row)
        lines.append("")

    return "\n".join(lines)
