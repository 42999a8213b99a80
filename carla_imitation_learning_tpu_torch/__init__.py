"""PyTorch / CUDA port of ``carla_imitation_learning_tpu`` for NVIDIA Hopper.

The closed-loop fleet rollout — batched driving sim, triangle rasterizer,
4-frame uint8 observation window, ``PolicyCNN`` forward, discrete action back
into the sim — as plain PyTorch on batched tensors, with the rasterizer
kernels written by hand in CUDA C++ for ``sm_90a`` (``csrc/``): the exact
z-buffer (flat and textured), the fast rollout kernel and its fused-quad and
grouped-table variants. The rich scene (facade bands, markings, shadows,
textures) and the semantic class stream of collection rollouts are ported,
and so is behaviour-cloning training on the card: collection into a
``FrameStore``, the device-resident ``DeviceDataset``, Adam train steps and
the ``Trainer``; so is training from CARLA-contract logs on disk through
the ``run`` entry point (``python -m carla_imitation_learning_tpu_torch.cli``)
with best-k checkpoints, and the scenario suite (``scenario_eval``: rain,
night, busy streets, multi-lane towns with lane changes, junction turn fans
whose draws are ``jax.random``'s, ``sim/prng.py``).

Layout mirrors the JAX package: ``sim/``, ``render/``, ``ops/``, ``models/``,
``data/`` (actions, frame logs, pipeline, stats, ETL), ``native/`` (the
packed and sharded frame stores, C++ built with g++), ``training/`` (closed
loop, losses, steps, loop, DAgger), ``parallel/`` (hyperparameter search:
the trial runner, vmapped sweeps, Population Based Training), ``utils/`` (profiling, checkpoints,
metric sinks), ``callbacks/``, ``config/`` with its ``configs/`` presets,
``experiments.py`` and ``cli.py``. The env axis that the JAX
package ``vmap``s is a leading ``B`` dimension here. Entry points take an
explicit ``device`` (default ``"cuda"``, which raises when there is no card)
and explicit ``torch.Generator``s. ``convert.py`` turns numpy pytrees of the
JAX package (flax params, ``TownMap``, ``WorldState``, spawn pool,
``TriangleSetup``) into this package's objects.

This package imports torch and numpy, and PyYAML for its presets and PIL
for PNG frames when those are used.
"""
