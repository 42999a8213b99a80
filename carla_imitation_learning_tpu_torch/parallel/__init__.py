"""Parallelism: data parallelism over ``torch.distributed`` (``parallel/mesh.py``:
the mesh, batch shardings, replicated train states, the multi-process
start) and the hyperparameter search of ``parallel/hpo.py`` (trial runner,
vectorized sweeps, Population Based Training)."""

from carla_imitation_learning_tpu_torch.parallel.hpo import (  # noqa: F401
    Trial, grid_space, pbt_run, sample_space, tune_run, vmap_sweep,
)
from carla_imitation_learning_tpu_torch.parallel.mesh import (  # noqa: F401
    BatchSharding, Mesh, Replicated, batch_sharding, make_mesh, maybe_mesh,
    multihost_initialize, rank_device, replicated_sharding, shard_batch,
    shard_train_state, world_size,
)
