"""Multi-device forms on ``torch.distributed`` (counterpart:
``montecarlooptionspricer_tpu/parallel``): one process per device."""

from .mesh import Mesh, init_distributed, make_mesh  # noqa: F401
from .sharded import (sharded_mean_payoff,  # noqa: F401
                      sharded_price_rbergomi)
