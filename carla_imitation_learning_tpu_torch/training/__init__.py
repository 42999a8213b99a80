"""Closed loop and collection (``closed_loop``), the losses, train steps and
the ``Trainer`` (``losses``, ``steps``, ``loop``), and the modules beside
them: DAgger, PPO, the shield, imagination training (``imagination``) and
the episode recorder (``replay``)."""

from carla_imitation_learning_tpu_torch.training.losses import (  # noqa: F401
    accuracy, aux_loss_fn, bc_loss_fn, cil_loss_fn, continuous_bc_loss_fn, cross_entropy,
    dual_stream_loss_fn, rnn_bc_loss_fn, vae_loss_fn, world_model_loss_fn,
)
