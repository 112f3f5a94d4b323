"""The port's copies of the JAX package's pure-Python modules stay copies.

A module listed in ``COPIES`` is the JAX package's file with the package's
name re-pointed (``repro`` to ``repro_torch``, in imports and in the
docstrings that name it) and nothing else, so its behaviour is the
reference's by construction; the differential tests then hold the replays
to the reference's with ``==``. A module listed in ``SAME_CODE`` has its
docstrings rewritten for the port: its code, parsed with the docstrings
removed, equals the reference's re-pointed code. A behavioural change to any
of them is a divergence, to be recorded in ROADMAP C and taken off these
lists.
"""

import ast
import pathlib
import re

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

COPIES = [
    "bridge/calibrate.py", "bridge/profiles.py",
    "cluster/__init__.py", "cluster/colocation.py", "cluster/dvfs.py", "cluster/fleet.py", "cluster/job.py",
    "cluster/jobqueue.py", "cluster/node.py", "cluster/simulator.py", "cluster/trace.py",
    "configs/deepseek_v2_lite_16b.py", "configs/deepseek_v3_671b.py", "configs/h2o_danube_1_8b.py",
    "configs/internlm2_20b.py", "configs/jamba_1_5_large_398b.py", "configs/minitron_8b.py",
    "configs/qwen3_32b.py", "configs/seamless_m4t_large_v2.py",
    "control/__init__.py", "control/injector.py", "control/live.py", "control/messages.py", "control/plane.py",
    "core/__init__.py", "core/baselines.py", "core/candidates.py", "core/cost.py", "core/eaco.py",
    "core/eaco_elastic.py", "core/eaco_powercap.py", "core/history.py", "core/predictor.py",
    "data/pipeline.py",
    "elastic/__init__.py", "elastic/brain.py", "elastic/controller.py", "elastic/scaling.py",
    "obs/__init__.py", "obs/audit.py", "obs/export.py", "obs/report.py", "obs/tables.py",
    "roofline/analysis.py",
    "serve/__init__.py", "serve/manager.py", "serve/models.py", "serve/stats.py",
]
SAME_CODE = ["bridge/__init__.py", "cluster/power.py", "obs/hub.py", "roofline/__init__.py"]


def _repointed(rel):
    return re.sub(r"\brepro\b(?!_torch)", "repro_torch", (SRC / "repro" / rel).read_text())


def _code(text):
    """The module's AST with every docstring removed."""
    tree = ast.parse(text)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_differs_only_in_the_package_name(rel):
    assert (SRC / "repro_torch" / rel).read_text() == _repointed(rel)


@pytest.mark.parametrize("rel", SAME_CODE)
def test_copy_differs_only_in_docstrings(rel):
    ours = (SRC / "repro_torch" / rel).read_text()
    assert ours != _repointed(rel)
    assert _code(ours) == _code(_repointed(rel))
