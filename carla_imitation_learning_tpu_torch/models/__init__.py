"""Policies (``nn.Module``s taking NHWC frame windows)."""

from carla_imitation_learning_tpu_torch.models.cnn import ConvTrunk, MLPHead, PolicyCNN  # noqa: F401
