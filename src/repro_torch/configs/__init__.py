"""Architecture configs the port runs.

Importing this package registers them in ``base.REGISTRY``: the dense GQA
configs minitron-8b, qwen3-32b (qk-norm), internlm2-20b, h2o-danube-1.8b
(sliding window) and internvl2-2b (a stubbed vision frontend), and the
attention-free SSM mamba2-370m. The MoE, MLA, hybrid and encoder-decoder
configs of the JAX package are not registered until their layers are ported.
"""

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ArchConfig,
    MLAConfig,
    MoEConfig,
    SSMConfig,
    ShapeSpec,
    all_configs,
    get_config,
    smoke_config,
)
from repro_torch.configs import (  # noqa: F401  (side-effect registration)
    h2o_danube_1_8b,
    internlm2_20b,
    internvl2_2b,
    mamba2_370m,
    minitron_8b,
    qwen3_32b,
)
