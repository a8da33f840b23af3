"""The database axis sharded over a device mesh: sharded encoding, codebook
updates and queries (port of `local_search_quantization_tpu.parallel`)."""

from local_search_quantization_torch.parallel import mesh
from local_search_quantization_torch.parallel.mesh import (
    data_mesh,
    replicated,
    shard_batch,
)

__all__ = ["mesh", "data_mesh", "replicated", "shard_batch"]
