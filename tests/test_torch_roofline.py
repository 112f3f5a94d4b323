"""Roofline analysis: HLO parsing and term computation (the pure-Python
tests of ``tests/test_roofline.py``, through the port's copy; the one that
compiles a sharded program needs JAX and is not twinned)."""

import pytest

from repro_torch.roofline.analysis import (
    Roofline,
    _shape_bytes,
    analyze,
    parse_collectives,
)


def test_shape_bytes():
    assert _shape_bytes("bf16[8,128]{1,0}") == 8 * 128 * 2
    assert _shape_bytes("f32[2,2,2]") == 32
    assert _shape_bytes("(bf16[4], f32[4])") == 8 + 16
    assert _shape_bytes("pred[16]") == 16
    assert _shape_bytes("s32[]") == 4


def test_parse_collectives_synthetic():
    hlo = """
  %p0 = bf16[128,64]{1,0} parameter(0)
  %ar = bf16[128,64]{1,0} all-reduce(%p0), replica_groups={}
  %ag = bf16[256,64]{1,0} all-gather(%p0), dimensions={0}
  %rs.1 = bf16[64,64]{1,0} reduce-scatter(%ar), dimensions={0}
  %cp = bf16[128,64]{1,0} collective-permute(%p0)
  %a2a = bf16[128,64]{1,0} all-to-all(%p0)
"""
    stats = parse_collectives(hlo)
    assert stats.counts == {
        "all-reduce": 1,
        "all-gather": 1,
        "reduce-scatter": 1,
        "all-to-all": 1,
        "collective-permute": 1,
    }
    b = 128 * 64 * 2
    assert stats.operand_bytes["all-reduce"] == b
    assert stats.operand_bytes["all-gather"] == b  # operand, not result
    assert stats.total_operand_bytes == 5 * b
    assert stats.wire_bytes == 6 * b  # all-reduce counts 2x


def test_parse_collectives_async_pairs_not_double_counted():
    hlo = """
  %p0 = bf16[128,64]{1,0} parameter(0)
  %ar0 = bf16[128,64]{1,0} all-reduce-start(%p0)
  %ar1 = bf16[128,64]{1,0} all-reduce-done(%ar0)
"""
    stats = parse_collectives(hlo)
    assert stats.counts == {"all-reduce": 1}


def test_analyze_terms():
    cost = {"flops": 197e12, "bytes accessed": 819e9}
    hlo = "  %p0 = bf16[1024,1024]{1,0} parameter(0)\n  %ar = bf16[1024,1024]{1,0} all-reduce(%p0)\n"
    r = analyze(cost, hlo, model_flops_global=197e12 * 256, num_chips=256)
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 1.0) < 1e-9
    assert r.collective_bytes == 1024 * 1024 * 2
    assert r.bottleneck in ("compute", "memory")
    assert abs(r.useful_ratio - 1.0) < 1e-9


def test_model_flops_for_cell():
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.roofline.analysis import model_flops_for_cell

    cfg = get_config("qwen3-32b")
    n = cfg.param_count(active_only=True)
    train = model_flops_for_cell(cfg, SHAPES["train_4k"])
    assert train == pytest.approx(6 * n * 256 * 4096)
    decode = model_flops_for_cell(cfg, SHAPES["decode_32k"])
    assert decode == pytest.approx(2 * n * 128)
    # MoE: active params, not total
    moe = get_config("deepseek-v3-671b")
    assert model_flops_for_cell(moe, SHAPES["train_4k"]) < 6 * moe.param_count() * 256 * 4096 / 5


# ---------------------------------------------------------- against the JAX package's copy

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import SHAPES as JAX_SHAPES  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402

from repro_torch.configs import ASSIGNED, SHAPES, families  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402


def test_families_equal_the_reference():
    """All ten assigned configs are registered, field for field the
    reference's, with the same parameter counts and state bytes."""
    import dataclasses

    from repro.configs import ASSIGNED as JAX_ASSIGNED
    from repro.configs import families as jax_families

    assert ASSIGNED == JAX_ASSIGNED
    ours, ref = families(), jax_families()
    assert list(ours) == list(ref)
    for name, cfg in ours.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref[name]), name
        assert cfg.param_count() == ref[name].param_count()
        assert cfg.param_count(active_only=True) == ref[name].param_count(active_only=True)
        for chips, n_model in ((256, 16), (512, 16), (8, 16), (256, 1)):
            assert cfg.train_state_bytes_per_chip(chips, n_model) == ref[name].train_state_bytes_per_chip(
                chips, n_model)


@pytest.mark.parametrize("name", sorted(ASSIGNED))
def test_analytic_terms_equal_the_reference(name):
    """Every analytic term of every cell of one family, through the port's
    copy and the JAX package's: equal with ``==``."""
    import dataclasses

    cfg, jcfg = families()[name], jax_get_config(name)
    for key, shape in SHAPES.items():
        jshape = JAX_SHAPES[key]
        for chips in (8, 256, 512):
            assert dataclasses.asdict(analysis.analytic_roofline(cfg, shape, chips)) == dataclasses.asdict(
                janalysis.analytic_roofline(jcfg, jshape, chips)), (key, chips)
            assert analysis.analytic_hbm_bytes(cfg, shape, chips) == janalysis.analytic_hbm_bytes(jcfg, jshape, chips)
            assert analysis.analytic_collective_bytes(cfg, shape, chips) == janalysis.analytic_collective_bytes(
                jcfg, jshape, chips)
            assert analysis.analytic_host_profile(cfg, shape, chips, 1.7) == janalysis.analytic_host_profile(
                jcfg, jshape, chips, 1.7)
        assert analysis.model_flops_for_cell(cfg, shape) == janalysis.model_flops_for_cell(jcfg, jshape)
        assert analysis.kv_cache_bytes(cfg, shape.global_batch, shape.seq_len) == janalysis.kv_cache_bytes(
            jcfg, jshape.global_batch, jshape.seq_len)


@pytest.mark.parametrize("name", ["jamba-1.5-large-398b", "seamless-m4t-large-v2"])
def test_model_refuses_the_families_it_does_not_run(name):
    """The two configs of the bridge's family universe outside the dense,
    MoE and SSM layouts, at full and at smoke size. The decoder-only
    ``Model`` refuses the encoder-decoder stack, as the reference's does,
    and ``build_model`` gives it ``EncDecModel``. jamba-1.5-large-398b's
    hybrid layout it builds, with the reference's parameter tree: every
    path and shape of ``param_defs`` equal."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models.encdec import EncDecModel
    from repro_torch.models.factory import build_model
    from repro_torch.models.transformer import Model

    for smoke in (False, True):
        cfg = smoke_config(get_config(name)) if smoke else get_config(name)
        if cfg.enc_dec:
            with pytest.raises(NotImplementedError, match="EncDecModel"):
                Model(cfg)
            assert isinstance(build_model(cfg), EncDecModel)
            continue
        from repro.configs import get_config as jax_get_config
        from repro.configs import smoke_config as jax_smoke_config
        from repro.models.transformer import Model as JaxModel

        jcfg = jax_smoke_config(jax_get_config(name)) if smoke else jax_get_config(name)
        model = build_model(cfg)
        assert isinstance(model, Model) and [(g, n) for g, n, _ in model.groups] == [("blocks", cfg.num_layers // 8)]
        assert _def_shapes(model.param_defs()) == _def_shapes(JaxModel(jcfg).param_defs())


def _def_shapes(tree, prefix=""):
    """{path: shape} of a nested dict of either package's ParamDefs."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out.update(_def_shapes(val, path) if isinstance(val, dict) else {path: tuple(val.shape)})
    return out


@pytest.mark.parametrize("name", ["deepseek-v3-671b", "deepseek-v2-lite-16b"])
def test_model_builds_and_trains_the_moe_families(name):
    """The two MoE + MLA configs that ``Model`` refused before: at full and
    at smoke size it defines their parameters (deepseek-v3-671b's with the
    MTP module) and builds their train bundle with the config's optimizer,
    allocating nothing."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models.factory import build_model
    from repro_torch.train.steps import make_train_bundle

    for cfg in (get_config(name), smoke_config(get_config(name))):
        defs = build_model(cfg).param_defs()
        assert ("mtp" in defs) == bool(cfg.mtp_depth) and "moe" in defs
        bundle = make_train_bundle(cfg)
        assert type(bundle.optimizer).__name__ == {"adamw": "AdamW", "adafactor": "Adafactor"}[cfg.optimizer]
