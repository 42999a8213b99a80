"""Policies (``nn.Module``s taking NHWC frame windows)."""

from carla_imitation_learning_tpu_torch.models.cil import BranchedCILPolicy  # noqa: F401
from carla_imitation_learning_tpu_torch.models.cnn import (  # noqa: F401
    ContinuousPolicyCNN, ConvTrunk, MLPHead, PolicyCNN,
)
