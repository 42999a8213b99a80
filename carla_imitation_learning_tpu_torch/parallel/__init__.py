"""Parallelism: the hyperparameter search of ``parallel/hpo.py`` (trial
runner, vectorized sweeps, Population Based Training). The port runs on
one device; the JAX package's mesh (``parallel/mesh.py``) is not ported
yet (ROADMAP Queue 1, item 6)."""

from carla_imitation_learning_tpu_torch.parallel.hpo import (  # noqa: F401
    Trial, grid_space, pbt_run, sample_space, tune_run, vmap_sweep,
)
