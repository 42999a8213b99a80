"""Policies (``nn.Module``s taking NHWC frame windows: the CNNs, CIL, the
recurrent policy and the ViT), the multi-task ``AuxNet``, the ``ConvVAE``
and the latent world model."""

from carla_imitation_learning_tpu_torch.models.aux import AuxNet, ReconDecoder  # noqa: F401
from carla_imitation_learning_tpu_torch.models.cil import BranchedCILPolicy  # noqa: F401
from carla_imitation_learning_tpu_torch.models.cnn import (  # noqa: F401
    ContinuousPolicyCNN, ConvTrunk, DualStreamCNN, MLPHead, PolicyCNN,
)
from carla_imitation_learning_tpu_torch.models.rnn_policy import RecurrentPolicy  # noqa: F401
from carla_imitation_learning_tpu_torch.models.vae import ConvVAE  # noqa: F401
from carla_imitation_learning_tpu_torch.models.vit import ViTPolicy  # noqa: F401
from carla_imitation_learning_tpu_torch.models.world_model import (  # noqa: F401
    FrameDecoder, FrameEncoder, LatentWorldModel,
)
