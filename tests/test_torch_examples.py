"""The twins of the JAX package's framework-free demos and tools
(``repro_torch.examples`` and ``repro_torch.tools``) against the reference's
own scripts, run in this process on the same arguments: each twin prints
what the reference prints, line for line, with only timings and file paths
masked (the event-loop profile's wall seconds, a chaos cell's seconds), and
writes the same files byte for byte (Perfetto traces, the chaos report less
its ``wall_s``, the drift report, the Prometheus snapshot, the JSONL dump).

The reference's scripts are loaded by path from ``examples/`` and ``tools/``
and their output files redirected under a temporary directory (the
reference's demos write to the system's temporary directory); the twins'
default directory, ``build/examples/``, is redirected the same way.
``chaos_replay`` runs its ``--smoke --skip-differential`` matrix and one
differential cell (the ``mixed`` scenario under EaCO at 30 jobs on 12
nodes): the whole file takes ~35 s on one CPU worker.
"""

import importlib.util
import json
import pathlib
import re
import tempfile

import pytest

from repro_torch.examples import bridge_demo, elastic_demo, failure_recovery, quickstart, telemetry_demo
from repro_torch.tools import chaos_replay, replay_report

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _reference(rel: str):
    """The reference's script at ``rel``, loaded as a fresh module."""
    spec = importlib.util.spec_from_file_location(f"reference_{pathlib.Path(rel).stem}", ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _masked(text: str, paths=()) -> list:
    """Lines with the given paths as ``<path>``, the event-loop profile's
    wall seconds and per-kind times masked and its rows sorted (their order
    follows the times), a chaos cell's seconds masked."""
    for p in paths:
        text = text.replace(str(p), "<path>")
    lines, out, profile = text.splitlines(), [], []
    in_profile = False
    for line in lines:
        line = re.sub(r"\(\d+\.\d+s\)$", "(<s>)", line)
        if line.startswith("event-loop profile"):
            in_profile = True
            line = re.sub(r", [\d.]+s wall\)", ", <s> wall)", line)
        elif in_profile and re.match(r"^  \w+\s+[\d,]+\s+[\d.]+\s+[\d.]+$", line):
            kind, count = line.split()[:2]
            profile.append(f"  {kind} {count} <s> <us>")
            continue
        elif in_profile and not line.strip():
            out.extend(sorted(profile))
            profile, in_profile = [], False
        out.append(line)
    return out + sorted(profile)


def _run(main, capsys, *args):
    main(*args)
    return capsys.readouterr().out


def test_bridge_demo_prints_what_the_reference_prints(capsys):
    ref = _run(_reference("examples/bridge_demo.py").main, capsys)
    assert _run(bridge_demo.main, capsys) == ref
    assert "History grew to" in ref and "done=60/60" in ref


def test_failure_recovery_prints_what_the_reference_prints(capsys):
    ref = _run(_reference("examples/failure_recovery.py").main, capsys)
    assert _run(failure_recovery.main, capsys) == ref
    assert ref.count("done=30/30") == 6


def test_elastic_demo_prints_what_the_reference_prints(capsys):
    ref = _run(_reference("examples/elastic_demo.py").main, capsys)
    assert _run(elastic_demo.main, capsys) == ref
    assert "resize plans applied by the Brain:" in ref


def test_quickstart_prints_and_writes_what_the_reference_does(tmp_path, monkeypatch, capsys):
    mod = _reference("examples/quickstart.py")
    write = mod.write_perfetto
    ref_path = tmp_path / "ref" / "quickstart_trace.json"
    ref_path.parent.mkdir()
    monkeypatch.setattr(mod, "write_perfetto", lambda hub, path, results: write(hub, str(ref_path), results))
    ref = _run(mod.main, capsys)
    monkeypatch.setattr(quickstart, "BUILD", tmp_path / "twin")
    twin = _run(quickstart.main, capsys)
    twin_path = tmp_path / "twin" / "quickstart_trace.json"
    assert _masked(twin, [twin_path]) == _masked(ref, [ref_path])
    assert str(twin_path) in twin and "EaCO saves" in twin
    assert twin_path.read_bytes() == ref_path.read_bytes()


@pytest.mark.parametrize("fast", ["1", "0"])
def test_telemetry_demo_prints_and_writes_what_the_reference_does(fast, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_EXAMPLES_FAST", fast)
    (tmp_path / "ref").mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "ref"))
    ref = _run(_reference("examples/telemetry_demo.py").main, capsys)
    monkeypatch.setattr(telemetry_demo, "BUILD", tmp_path / "twin")
    twin = _run(telemetry_demo.main, capsys)
    ref_path, twin_path = (tmp_path / d / "repro_telemetry_demo.json" for d in ("ref", "twin"))
    assert _masked(twin, [twin_path]) == _masked(ref, [ref_path])
    assert "event-loop profile" in twin and str(twin_path) in twin
    assert twin_path.read_bytes() == ref_path.read_bytes()


def _chaos_report(path: pathlib.Path) -> dict:
    report = json.loads(path.read_text())
    for cell in report["cells"]:
        cell["wall_s"] = None
    return report


@pytest.mark.parametrize("args", [
    ["--smoke", "--skip-differential"],
    ["--scenarios", "mixed", "--schedulers", "eaco", "--diff-jobs", "30", "--diff-nodes", "12"],
], ids=["smoke", "differential"])
def test_chaos_replay_prints_and_writes_what_the_reference_does(args, tmp_path, capsys):
    ref_out, twin_out = tmp_path / "ref" / "chaos.json", tmp_path / "twin" / "chaos.json"
    assert _reference("tools/chaos_replay.py").main(args + ["--out", str(ref_out)]) == 0
    ref = capsys.readouterr().out
    assert chaos_replay.main(args + ["--out", str(twin_out)]) == 0
    twin = capsys.readouterr().out
    assert _masked(twin, [twin_out]) == _masked(ref, [ref_out])
    assert _chaos_report(twin_out) == _chaos_report(ref_out)
    assert ("differential gate" in twin) == ("--skip-differential" not in args)


@pytest.mark.parametrize("args", [
    ["--profile"],
    ["--scheduler", "eaco-powercap", "--power-cap", "38900", "--jobs", "40", "--mix", "lm"],
], ids=["eaco", "powercap"])
def test_replay_report_prints_and_writes_what_the_reference_does(args, tmp_path, capsys):
    files = {"--perfetto": "trace.json", "--prom": "metrics.prom", "--jsonl": "events.jsonl", "--drift": "drift.json"}
    outs = {}
    for side, main in (("ref", _reference("tools/replay_report.py").main), ("twin", replay_report.main)):
        (tmp_path / side).mkdir()
        flags = [x for flag, name in files.items() for x in (flag, str(tmp_path / side / name))]
        assert main(args + flags) == 0
        outs[side] = _masked(capsys.readouterr().out, [tmp_path / side])
    assert outs["twin"] == outs["ref"]
    assert any(line.startswith("perfetto trace -> <path>") for line in outs["twin"])
    for name in files.values():
        assert (tmp_path / "twin" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes(), name


def test_tools_take_the_reference_flags():
    ref_chaos, ref_report = _reference("tools/chaos_replay.py"), _reference("tools/replay_report.py")
    for ours, theirs in ((chaos_replay, ref_chaos), (replay_report, ref_report)):
        a, b = ours.build_parser(), theirs.build_parser()
        assert sorted(a._option_string_actions) == sorted(b._option_string_actions)
        assert {x.dest: x.default for x in a._actions} == {x.dest: x.default for x in b._actions}
    assert chaos_replay.SCHEDULERS.keys() == ref_chaos.SCHEDULERS.keys()
    assert replay_report.SCHEDULERS.keys() == ref_report.SCHEDULERS.keys()
