"""Site sharding over the ranks of a torch.distributed process group
(counterpart of libpll2_tpu.parallel), and the launcher that starts the
ranks (parallel.launcher.launch)."""
from .sharding import (SITES_AXIS, make_mesh, pad_sites_to_mesh,
                       replicated, shard_site_arrays, site_sharding)
from .distributed import (global_site_mesh, initialize,
                          make_global_site_array, process_site_slice,
                          shard_engine_inputs)
from .launcher import launch

__all__ = [
    "SITES_AXIS", "make_mesh", "site_sharding", "replicated",
    "shard_site_arrays", "pad_sites_to_mesh",
    "initialize", "global_site_mesh", "make_global_site_array",
    "shard_engine_inputs", "process_site_slice",
]
