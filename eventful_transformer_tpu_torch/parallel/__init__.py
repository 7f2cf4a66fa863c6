from eventful_transformer_tpu_torch.parallel.mesh import (
    best_dp_tp_mesh,
    dp_tp_shape,
    initialize_distributed,
    make_mesh,
    prefix_mesh,
    spawn,
)
from eventful_transformer_tpu_torch.parallel.pipeline import make_pipelined_backbone
from eventful_transformer_tpu_torch.parallel.sharding import (
    gathered_params,
    shard_params,
    vit_param_spec,
    vit_param_specs,
)
from eventful_transformer_tpu_torch.parallel.train import (
    cross_entropy_from_probs,
    make_sharded_train_step,
)

__all__ = [
    "best_dp_tp_mesh",
    "cross_entropy_from_probs",
    "dp_tp_shape",
    "gathered_params",
    "initialize_distributed",
    "make_mesh",
    "make_pipelined_backbone",
    "make_sharded_train_step",
    "prefix_mesh",
    "shard_params",
    "spawn",
    "vit_param_spec",
    "vit_param_specs",
]
