from .mesh import (AXIS_ORDER, Mesh, make_hybrid_mesh, make_mesh, mesh_shape_for,
                   one_device_mesh)
from .sharding import (ShardPlan, batch_spec, gather_params, llama_param_specs,
                       shard_params)
from .ring import make_ring_attn, ring_attention, ring_attention_emulated
from .train import (build_llama_train_step, init_opt_state, param_leaves,
                    quick_mesh_and_step)

__all__ = [
    "AXIS_ORDER",
    "Mesh",
    "make_hybrid_mesh",
    "make_mesh",
    "mesh_shape_for",
    "one_device_mesh",
    "ShardPlan",
    "batch_spec",
    "gather_params",
    "llama_param_specs",
    "shard_params",
    "make_ring_attn",
    "ring_attention",
    "ring_attention_emulated",
    "build_llama_train_step",
    "init_opt_state",
    "param_leaves",
    "quick_mesh_and_step",
]
