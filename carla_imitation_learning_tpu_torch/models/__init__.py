"""Policies (``nn.Module``s taking NHWC frame windows), the multi-task
``AuxNet`` and the ``ConvVAE``."""

from carla_imitation_learning_tpu_torch.models.aux import AuxNet, ReconDecoder  # noqa: F401
from carla_imitation_learning_tpu_torch.models.cil import BranchedCILPolicy  # noqa: F401
from carla_imitation_learning_tpu_torch.models.cnn import (  # noqa: F401
    ContinuousPolicyCNN, ConvTrunk, DualStreamCNN, MLPHead, PolicyCNN,
)
from carla_imitation_learning_tpu_torch.models.vae import ConvVAE  # noqa: F401
