"""The twins of the JAX package's two model demos
(``repro_torch.examples.train_lm`` and ``colocation_demo``) on the CPU in
``REPRO_EXAMPLES_FAST`` mode, and both launchers' ``--smoke`` for every
config of ``configs.ASSIGNED``.

* ``train_lm --device cpu``: 30 steps, a simulated preemption, a new trainer
  restored from the step-30 checkpoint (the checkpoint crossed at step 25),
  60 steps in all, the loss falling; its checkpoints in a temporary
  directory under ``build/examples/`` (here redirected), removed at the end.
* ``colocation_demo --device cpu``: minitron-8b and mamba2-370m smoke through
  ``TemporalStepper`` and ``EarlyStageProfiler``: solo step times, the
  co-located ones with their inflation, both jobs run to their epoch's end.
* Without a card both demos exit non-zero unless given ``--device cpu``,
  and print nothing.
* Both launchers take ``--smoke`` for all ten configs: without a card they
  exit only for want of one, and with ``--device cpu`` they run; every
  kernel call of the smoke serve (a 40-token prefill of batch 2 and a decode
  step over 48 slots) and of a smoke train step passes the launch path's
  checks (head dims, alignment) in the wrappers' fake branches, at the
  launch counts ``chip_smoke.py`` asserts on the card.

The card runs of the demos are ``chip_smoke.py``'s ``demos_phase``.
"""

import inspect
import re

import pytest
import torch

from repro_torch.configs import ASSIGNED, ShapeSpec, get_config, input_specs, smoke_config
from repro_torch.examples import colocation_demo, train_lm
from repro_torch.launch import dryrun, serve
from repro_torch.launch import train as train_launcher


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The smoke shapes gain nothing from intra-op threads; one torch thread
    keeps the ``-n 6`` workers on a few cores from slowing each other's
    small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fast(monkeypatch):
    monkeypatch.setenv("REPRO_EXAMPLES_FAST", "1")


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_train_lm_crosses_a_checkpoint_and_the_loss_falls(fast, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(train_lm, "BUILD", tmp_path)
    train_lm.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "fresh init"
    assert "— simulated preemption: restarting from latest checkpoint —" in lines
    restored = [x for x in lines if x.startswith("restored step ")]
    assert len(restored) == 1 and restored[0].startswith("restored step 30 from " + str(tmp_path))
    report = next(x for x in lines if x.startswith("final report:"))
    assert "'steps': 60" in report
    first, final = (float(re.search(rf"'{k}': ([^,}}]+)", report).group(1)) for k in ("first_loss", "final_loss"))
    assert final < first
    assert lines[-1] == "loss decreased: OK"
    assert list(tmp_path.iterdir()) == []  # the checkpoints' directory is removed


def test_colocation_demo_prints_its_inflation(fast, capsys):
    colocation_demo.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "— solo baselines (exclusive) —"
    assert [x.split()[0] for x in lines[1:3]] == ["minitron-8b", "mamba2-370m"]
    assert all(x.endswith("ms/step") for x in lines[1:3])
    assert lines[3] == "— co-located (round-robin temporal sharing) —"
    inflation = [re.search(r"inflation\s+([\d.]+)x$", x) for x in lines[4:6]]
    assert all(m is not None and float(m.group(1)) > 0 for m in inflation)
    assert lines[6] == "— run both jobs to completion (checkpointing every epoch) —"
    assert [x.split()[0] for x in lines[7:9]] == ["minitron-8b", "mamba2-370m"]
    assert all("steps=  2 loss" in x for x in lines[7:9])


@pytest.mark.parametrize("demo", [train_lm, colocation_demo], ids=["train_lm", "colocation_demo"])
def test_demos_without_a_card_exit_nonzero(demo, fast, no_card, capsys):
    with pytest.raises(SystemExit) as exc:
        demo.main([])
    assert exc.value.code not in (0, None) and "no CUDA device" in str(exc.value.code)
    assert "--device cpu" in str(exc.value.code)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("arch", ASSIGNED)
def test_launchers_take_smoke_for_every_config(arch, no_card, capsys):
    for main in (serve.main, train_launcher.main):
        with pytest.raises(SystemExit) as exc:
            main(["--arch", arch, "--smoke"])
        assert "no CUDA device" in str(exc.value.code)
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "1", "--prompt-len", "12",
                "--decode-steps", "2"])
    out = capsys.readouterr().out
    assert out.startswith("prefill 12 tokens x1:") and "generated:" in out
    train_launcher.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--seq", "16", "--steps", "1"])
    out = capsys.readouterr().out
    assert out.startswith("fresh init") and "'steps': 1" in out


def test_launcher_docs_name_no_missing_kernel():
    for mod in (train_launcher, serve):
        assert "no flash kernel" not in inspect.getsource(mod)


def _expected(cfg):
    """chip_smoke.py's launch counts, less the kernels a config does not run."""
    import chip_smoke

    prefill, step = chip_smoke.serve_launches(cfg)
    train = chip_smoke.train_launches(cfg)
    return tuple({k: v for k, v in c.items() if v} for c in (prefill, step, train))


@pytest.mark.parametrize("arch", ASSIGNED)
def test_the_smoke_launch_paths_pass_the_kernels_checks(arch):
    """The smoke zoo's serve prefill and decode step and a smoke train step
    on fake tensors (the dry run's ``reckon_serve`` / ``reckon_card_step``):
    every kernel call takes the wrappers' fake branch, which runs the launch
    path's checks, so none would refuse on the card; the calls are those
    ``chip_smoke.py`` counts."""
    cfg = smoke_config(get_config(arch))
    prefill = dryrun.reckon_serve(cfg, None, ("data",), "prefill", input_specs(cfg, ShapeSpec("smoke", 40, 2, "prefill")),
                                  max_len=48)
    step = dryrun.reckon_serve(cfg, None, ("data",), "decode", input_specs(cfg, ShapeSpec("smoke", 48, 2, "decode")),
                               max_len=48)
    trained = dryrun.reckon_card_step(cfg, None, 4, 128)
    assert (prefill["kernel_calls"], step["kernel_calls"], trained["kernel_calls"]) == _expected(cfg)
