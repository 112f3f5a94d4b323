"""Telemetry exporters: Perfetto/Chrome-trace JSON, Prometheus, JSONL.

  * :func:`to_perfetto` — the Chrome trace-event JSON format that
    Perfetto (https://ui.perfetto.dev) opens directly: one process track
    per node carrying the job placement spans that ran there (one thread
    row per job, so spans never self-overlap), plus fleet-wide counter
    tracks for instantaneous power draw and any recorded gauges.
    Simulated hours map to trace microseconds at real scale (1 h =
    3.6e9 us), so span durations read as wall-clock time;
  * :func:`to_prometheus` — a text-format (exposition format 0.0.4)
    snapshot of ``Simulator.results()`` scalars plus per-family drift
    gauges, suitable for a node-exporter-style textfile collector;
  * :func:`write_jsonl` — every hub table flattened to one JSON object
    per line (``{"table": ..., <columns>}``), the replayable raw stream.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, Iterator, List, Optional

# simulated hours -> Chrome trace microseconds (real-time scale)
US_PER_HOUR = 3_600_000_000.0


def _us(t_h: float) -> float:
    return t_h * US_PER_HOUR


def to_perfetto(hub, results: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Build the Chrome-trace JSON dict for ``hub``.

    Tracks: pid 0 = the fleet (power/gauge counter tracks); pid ``n+1`` =
    node ``n``, with one complete ("X") span per job placement on thread
    ``tid = job_id``.  Spans still open at the end of the recorded stream
    are closed at the last observed timestamp.  ``results`` (optional) is
    embedded under ``metadata`` for self-describing traces.
    """
    events: List[Dict[str, Any]] = []
    t_max = 0.0

    def meta(pid: int, name: str, what: str = "process_name", tid: int = 0):
        ev = {"ph": "M", "pid": pid, "name": what, "args": {"name": name}}
        if what == "thread_name":
            ev["tid"] = tid
        events.append(ev)

    meta(0, "fleet")
    for nid, sku, n_gpus in hub.fleet:
        meta(nid + 1, f"node{nid} [{sku} x{n_gpus}]")

    # job spans: place opens, dealloc/complete closes (same node+tid)
    open_spans: Dict[int, Dict[str, Any]] = {}
    for row in hub.jobs.rows():
        t = row["t"]
        t_max = max(t_max, t)
        kind = row["kind"]
        jid = row["job_id"]
        if kind == "place":
            open_spans[jid] = row
        elif kind in ("dealloc", "complete"):
            placed = open_spans.pop(jid, None)
            if placed is not None:
                events.append(_span(placed, t, closing=row))
        elif kind == "submit":
            continue
        # "resize" rows are markers; the dealloc/place pair around them
        # already splits the span at the resize boundary

    for jid, placed in sorted(open_spans.items()):
        events.append(_span(placed, max(t_max, placed["t"]), closing=None))

    # counter tracks (timestamps are already monotone: sim time is)
    for row in hub.fleet_power.rows():
        t_max = max(t_max, row["t"])
        events.append(
            {
                "ph": "C", "pid": 0, "name": "fleet_power_w",
                "ts": _us(row["t"]), "args": {"watts": row["power_w"]},
            }
        )
    for row in hub.gauges.rows():
        events.append(
            {
                "ph": "C", "pid": 0, "name": row["name"],
                "ts": _us(row["t"]), "args": {"value": row["value"]},
            }
        )

    # instantaneous markers: DVFS changes on their node, cap actions fleet-wide
    for row in hub.freq_changes.rows():
        events.append(
            {
                "ph": "i", "s": "p", "pid": row["node_id"] + 1, "tid": 0,
                "name": f"freq step {row['step']} ({row['freq']:.2f}x)",
                "cat": "dvfs", "ts": _us(row["t"]),
            }
        )
    for row in hub.cap_actions.rows():
        pid = row["node_id"] + 1 if row["node_id"] >= 0 else 0
        events.append(
            {
                "ph": "i", "s": "p" if pid else "g", "pid": pid, "tid": 0,
                "name": f"cap:{row['action']}", "cat": "powercap",
                "ts": _us(row["t"]),
            }
        )
    # injected/MTBF faults on their node's track (straggles carry the
    # installed slowdown so traces show degraded-node spans at a glance)
    for row in hub.node_events.rows():
        name = f"{row['kind']}:{row['cause']}"
        if row["kind"] == "straggle" or (
            row["kind"] == "repair" and row["factor"] != 1.0
        ):
            name += f" x{row['factor']:.2f}"
        events.append(
            {
                "ph": "i", "s": "p", "pid": row["node_id"] + 1, "tid": 0,
                "name": name, "cat": "fault", "ts": _us(row["t"]),
            }
        )

    trace: Dict[str, Any] = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {"scale": "1 simulated hour = 3.6e9 us"},
    }
    if results is not None:
        trace["metadata"]["results"] = {
            k: v for k, v in results.items() if isinstance(v, (int, float, str))
        }
    return trace


def _span(placed: Dict[str, Any], t_end: float, closing) -> Dict[str, Any]:
    """One complete ("X") Chrome-trace span for a job placement."""
    args = {
        "job_id": placed["job_id"],
        "n_gpus": placed["n_gpus"],
        "degree": placed["degree"],
    }
    if closing is not None and closing.get("detail"):
        args["end"] = closing["detail"]
    return {
        "ph": "X",
        "pid": placed["node_id"] + 1,
        "tid": placed["job_id"],
        "name": f"{placed['family']} x{placed['n_gpus']}",
        "cat": "job",
        "ts": _us(placed["t"]),
        "dur": _us(max(t_end - placed["t"], 0.0)),
        "args": args,
    }


def write_perfetto(hub, path: str, results: Optional[Dict[str, Any]] = None) -> str:
    """Write the Chrome-trace JSON to ``path``; returns the path."""
    with open(path, "w") as f:
        json.dump(to_perfetto(hub, results), f)
    return path


# --------------------------------------------------------------- prometheus


def _prom_name(key: str) -> str:
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in key)


def _prom_label(value: str) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"')


def to_prometheus(
    results: Dict[str, Any], hub=None, prefix: str = "repro_"
) -> str:
    """Render a Prometheus text-format snapshot.

    Every scalar in ``results`` becomes a gauge ``<prefix><key>``; when a
    hub with an audit log is given, per-family drift gauges
    (``<prefix>predictor_abs_err{family=...}``) and per-table row counts
    (``<prefix>telemetry_rows{table=...}``) are appended.
    """
    lines: List[str] = []
    for key in sorted(results):
        v = results[key]
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        if isinstance(v, float) and not math.isfinite(v):
            continue
        name = _prom_name(prefix + key)
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {v}")
    if hub is not None:
        name = _prom_name(prefix + "telemetry_rows")
        lines.append(f"# TYPE {name} gauge")
        for table, n in sorted(hub.counts().items()):
            lines.append(f'{name}{{table="{_prom_label(table)}"}} {n}')
        if hub.audit is not None:
            drift = hub.drift_report()
            name = _prom_name(prefix + "predictor_abs_err")
            lines.append(f"# TYPE {name} gauge")
            for fam, g in drift.get("by_family", {}).items():
                if g.get("n"):
                    lines.append(
                        f'{name}{{family="{_prom_label(fam)}"}} '
                        f"{g['mean_abs_err']:.6f}"
                    )
    return "\n".join(lines) + "\n"


# -------------------------------------------------------------------- jsonl


def iter_jsonl(hub) -> Iterator[str]:
    """Yield every hub table row as one JSON line (``table`` keyed)."""
    for table_name, table in hub.tables().items():
        for row in table.rows():
            yield json.dumps({"table": table_name, **row}, default=str)


def write_jsonl(hub, path: str) -> str:
    """Write the full JSONL dump to ``path``; returns the path."""
    with open(path, "w") as f:
        for line in iter_jsonl(hub):
            f.write(line)
            f.write("\n")
    return path
