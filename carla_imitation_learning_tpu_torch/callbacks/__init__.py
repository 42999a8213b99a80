"""Training callbacks (the JAX package's ``callbacks/``): the ``Trainer``
calls hooks by name, ``on_fit_start(trainer, state)``,
``on_epoch_end(trainer, state, epoch, metrics, loaders)`` and
``on_fit_end(trainer, state, history)``."""

from carla_imitation_learning_tpu_torch.callbacks.callbacks import (  # noqa: F401
    Callback,
    SaveBestMetricScores,
    SaveConfusionMatrix,
    SaveMetricsHeatmap,
)
