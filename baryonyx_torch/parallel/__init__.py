"""Multi-card scaling: replica sharding over one process per card, and
constraint-row sharding for instances whose state overflows one card.

reference: the reference's only parallel axis is the std::thread
multi-start pool with a mutex-shared population
(itm-optimizer-common.hpp:802-862); here replicas live on the trailing
tensor axis and split across processes.
"""

from baryonyx_torch.parallel.distributed import (
    gather_to_host,
    init_distributed,
    is_multiprocess,
)
from baryonyx_torch.parallel.mesh import Mesh, make_mesh, shard_opt_state
