"""Entry point: the tiny Llama forward with its example arguments, the twin
of the JAX package's `__graft_entry__.entry()`."""

from __future__ import annotations

from functools import partial

import torch

from ._device import resolve_device
from .models import LlamaConfig, init_llama, llama_forward


def entry(device="cuda"):
    """-> (fn, (params, tokens)): `fn(params, tokens)` is the forward of
    `LlamaConfig.tiny()` with weights from seed 0 and tokens [2, 128] from
    seed 1, on `device`."""
    dev = resolve_device(device)
    config = LlamaConfig.tiny()
    params = init_llama(config, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, config.vocab_size, (2, 128), generator=gen,
                           device=dev)
    return partial(llama_forward, config=config), (params, tokens)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", tuple(out.shape), str(out.dtype))
