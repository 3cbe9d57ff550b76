"""The distributed layer of the port (``repro.parallel``): the sharding
mapper, the pipeline planner, and collective byte counting
(``comm.collective_bytes``, the role of the reference's ``hlo.py``)."""
from .mapper import (ShardingMapper, choose_rules, param_shardings,  # noqa
                     spec_shardings)
from .comm import collective_bytes  # noqa: F401
