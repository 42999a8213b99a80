"""Serving tier (the JAX package's ``serving/``): a policy exported with
``torch.export`` into one self-contained artifact (``export.py``), its int8
variant (``quant.py``), a bucketed batching engine (``engine.py``) and an
HTTP server with a micro-batcher (``server.py``).

The JAX package's functions that take ``(model, params)`` take the model
alone here: a torch module carries its weights."""

from carla_imitation_learning_tpu_torch.serving.engine import InferenceEngine
from carla_imitation_learning_tpu_torch.serving.export import (
    LoadedPolicy,
    export_cil_policy,
    export_fn,
    export_policy,
    load_policy,
    policy_fn_from_servable,
)
from carla_imitation_learning_tpu_torch.serving.quant import (
    make_quantized_policy,
    quantize_params,
    quantized_apply,
)
from carla_imitation_learning_tpu_torch.serving.server import PolicyServer

__all__ = [
    "InferenceEngine",
    "LoadedPolicy",
    "PolicyServer",
    "export_cil_policy",
    "export_fn",
    "export_policy",
    "load_policy",
    "policy_fn_from_servable",
    "make_quantized_policy",
    "quantize_params",
    "quantized_apply",
]
