from .llama import LlamaConfig, init_llama, llama_forward, llama_loss
from .generate import (
    KVCache,
    RollingKVCache,
    decode_step,
    generate,
    make_generate_fn,
    prefill,
)
from .convert import params_from_jax, resnet_params_from_jax
from .resnet import ResNet, ResNet50, resnet_forward_fn

__all__ = [
    "LlamaConfig",
    "init_llama",
    "llama_forward",
    "llama_loss",
    "KVCache",
    "RollingKVCache",
    "decode_step",
    "generate",
    "make_generate_fn",
    "prefill",
    "params_from_jax",
    "resnet_params_from_jax",
    "ResNet",
    "ResNet50",
    "resnet_forward_fn",
]
