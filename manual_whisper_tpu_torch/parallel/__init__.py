from .mesh import (DATA_AXIS, MODEL_AXIS, make_mesh, param_sharding_rules,
                   shard_batch, shard_params)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "make_mesh", "param_sharding_rules",
           "shard_batch", "shard_params"]
