from pix2latent_tpu_torch.parallel import multihost
from pix2latent_tpu_torch.parallel.mesh import (
    make_mesh,
    pad_population,
    population_sharding,
    replicate,
    shard_variables,
)

__all__ = ["make_mesh", "population_sharding", "shard_variables",
           "replicate", "pad_population", "multihost"]
