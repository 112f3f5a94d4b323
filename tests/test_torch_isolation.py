"""The port stands alone: it imports neither JAX nor the JAX package, its
launchers refuse to move to the CPU by themselves, and its kernel wrappers
count only real kernel launches."""

import importlib
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.kernels import ops

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

# Runs in a fresh interpreter whose imports of jax and repro (not repro_torch) fail.
_BLOCKED_IMPORTS = r"""
import importlib, importlib.abc, pathlib, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
assert "repro_torch.models.encdec" in names, names
twins = {f"repro_torch.examples.{m}" for m in ("colocation_demo", "train_lm", "bridge_demo", "quickstart",
                                              "elastic_demo", "failure_recovery", "telemetry_demo")}
assert twins | {"repro_torch.tools.chaos_replay", "repro_torch.tools.replay_report"} <= set(names), names
root = pathlib.Path(repro_torch.__path__[0])  # every source file of the package is among the modules imported
files = {".".join(("repro_torch",) + p.relative_to(root).with_suffix("").parts) for p in root.rglob("*.py")}
assert {f.removesuffix(".__init__") for f in files} <= set(names) | {"repro_torch"}, sorted(files - set(names))
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
print(len(names), "modules")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    return env


def test_port_imports_without_jax_or_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORTS], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 30
    assert out.stdout.splitlines() == [out.stdout.split()[0] + " modules"]  # importing a demo or tool runs nothing


def test_no_source_names_jax_or_the_jax_package():
    sources = [p for p in PORT.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    assert len(sources) >= 20
    for path in sources:
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M), path
        assert not re.search(r"\brepro\b(?!_torch)", text), path


def test_serve_launcher_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "minitron-8b", "--smoke"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr
    assert "prefill" not in out.stdout


def test_train_launcher_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "mamba2-370m", "--smoke", "--steps", "1"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr
    assert "report" not in out.stdout and "fresh init" not in out.stdout


def test_train_launcher_runs_on_the_cpu_when_asked(tmp_path, capsys):
    from repro_torch.launch import train

    args = ["--arch", "mamba2-370m", "--smoke", "--device", "cpu", "--batch", "2", "--seq", "32",
            "--steps-per-epoch", "2", "--ckpt-dir", str(tmp_path)]
    train.main(args + ["--steps", "2"])
    out = capsys.readouterr().out
    assert out.startswith("fresh init") and "'steps': 2" in out
    train.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert out.startswith("restored step 2") and "'steps': 3" in out


def test_trajectories_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.train.trajectories", "--arch", "mamba2-370m", "--smoke", "--steps", "1"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr
    assert "losses" not in out.stdout


def test_trajectories_run_on_the_cpu_when_asked(capsys):
    """Two paths from the same weights and batches: the same first loss, a gap printed per path."""
    from repro_torch.train import trajectories

    trajectories.main(["--arch", "mamba2-370m", "--smoke", "--device", "cpu", "--batch", "2", "--seq", "32",
                       "--steps", "2", "--lr", "1e-3", "--paths", "kernels", "plain", "rmsnorm"])
    lines = capsys.readouterr().out.strip().splitlines()
    firsts = {line.split(": losses ")[0]: line.split(": losses ")[1].split()[0] for line in lines if ": losses " in line}
    assert len(firsts) == 3 and len(set(firsts.values())) == 1
    assert sum("largest per-step relative gap to plain" in line for line in lines) == 2
    with pytest.raises(ValueError):
        trajectories.path_ops("flash")


def test_chip_smoke_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "ModuleNotFoundError" in out.stderr and '"ok"' not in out.stdout


def test_wrappers_do_not_count_cpu_launches():
    ops.reset_launch_counts()
    x = torch.randn(3, 8, 2, 32)
    ops.rmsnorm(x, torch.ones(32))
    ops.flash_attention(x, x[:, :4], x[:, :4], causal=False)
    ops.decode_attention(x[:, :, 0], x.transpose(1, 2), x.transpose(1, 2), 2)
    ops.ssd_scan(x, -x[..., 0].abs(), x[:, :, :1, :8], x[:, :, :1, 8:16], chunk=4)
    assert ops.launch_counts() == {
        "rmsnorm": 0, "flash_attention": 0, "decode_attention": 0, "ssd_scan": 0,
    }


def test_every_kernel_module_names_what_it_replaces():
    for name in ("rmsnorm", "flash_attention", "decode_attention", "ssd_scan"):
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        assert "Pallas TPU kernel" in mod.__doc__ and "bound by" in mod.__doc__.lower()
        assert (PORT / "kernels" / "csrc" / f"{name}.cu").exists()
