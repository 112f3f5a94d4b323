"""Assigned architecture configs (public-literature geometries).

Importing this package registers all ten of the JAX package's configs in
``base.REGISTRY``, field for field. The port's ``models.transformer.Model``
runs nine of them: the dense GQA configs minitron-8b, qwen3-32b (qk-norm),
internlm2-20b, h2o-danube-1.8b (sliding window) and internvl2-2b (a stubbed
vision frontend), the attention-free SSM mamba2-370m, deepseek-v3-671b and
deepseek-v2-lite-16b (MLA and MoE) and jamba-1.5-large-398b (a hybrid
pattern of Mamba-2 and attention layers with MoE). seamless-m4t-large-v2 (an
encoder-decoder stack) runs in ``models.encdec.EncDecModel``;
``models.factory.build_model`` picks the class. ``families()`` is also the
calibration bridge's model-family universe (``bridge/profiles.py``), which
reads only their geometry.
"""

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ArchConfig,
    InputSpec,
    MLAConfig,
    MoEConfig,
    SSMConfig,
    ShapeSpec,
    all_configs,
    get_config,
    input_specs,
    smoke_config,
)

# side-effect registration
from repro_torch.configs import (  # noqa: F401
    internvl2_2b,
    minitron_8b,
    qwen3_32b,
    internlm2_20b,
    h2o_danube_1_8b,
    deepseek_v3_671b,
    deepseek_v2_lite_16b,
    mamba2_370m,
    seamless_m4t_large_v2,
    jamba_1_5_large_398b,
)

ASSIGNED = [
    "internvl2-2b",
    "minitron-8b",
    "qwen3-32b",
    "internlm2-20b",
    "h2o-danube-1.8b",
    "deepseek-v3-671b",
    "deepseek-v2-lite-16b",
    "mamba2-370m",
    "seamless-m4t-large-v2",
    "jamba-1.5-large-398b",
]


def families():
    """Assigned arch configs keyed by name, in a stable (name-sorted) order —
    the model-family universe the calibration bridge (``repro_torch.bridge``)
    derives cluster ``JobProfile``s for."""
    return {name: get_config(name) for name in sorted(ASSIGNED)}
