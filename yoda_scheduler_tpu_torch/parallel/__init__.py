from .mesh import (AXIS_ORDER, Mesh, make_hybrid_mesh, make_mesh, mesh_shape_for,
                   one_device_mesh)
from .sharding import (ShardPlan, batch_spec, gather_params, llama_param_specs,
                       shard_params)
from .ring import make_ring_attn, ring_attention, ring_attention_emulated
from .ulysses import make_ulysses_attn, ulysses_attention, ulysses_attention_emulated
from .train import (build_llama_train_step, init_opt_state, param_leaves,
                    quick_mesh_and_step)
from .pipeline import (build_pipelined_llama_train_step, llama_pipeline_param_specs,
                       pipelined_llama_loss)
from .multihost import (bind_assigned_cards, gang_process_env, global_batch,
                        initialize_multihost)
from .checkpoint import TrainCheckpointer

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
    "make_ulysses_attn",
    "ulysses_attention",
    "ulysses_attention_emulated",
    "build_llama_train_step",
    "init_opt_state",
    "param_leaves",
    "quick_mesh_and_step",
    "build_pipelined_llama_train_step",
    "llama_pipeline_param_specs",
    "pipelined_llama_loss",
    "bind_assigned_cards",
    "gang_process_env",
    "global_batch",
    "initialize_multihost",
    "TrainCheckpointer",
]
