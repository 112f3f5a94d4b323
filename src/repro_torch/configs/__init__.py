"""Architecture configs the port runs.

Importing this package registers them in ``base.REGISTRY``. Only the configs
the port can serve are registered: the dense GQA minitron-8b and the
attention-free SSM mamba2-370m.
"""

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    MLAConfig,
    MoEConfig,
    SSMConfig,
    get_config,
    smoke_config,
)
from repro_torch.configs import mamba2_370m, minitron_8b  # noqa: F401  (side-effect registration)
