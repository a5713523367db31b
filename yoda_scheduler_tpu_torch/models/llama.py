"""Llama-class decoder-only transformer in PyTorch.

The port of yoda_scheduler_tpu/models/llama.py. Parameters are a plain dict
of tensors like the JAX pytree, except that the layers are a list of
per-layer dicts instead of arrays stacked on a leading layer axis (the
forward is a Python loop over layers, not a scan). Weights are [in, out], so
`x @ w` reads as in the JAX package. Matmuls run in the config's dtype;
RMSNorm, rotary, the SiLU gate and the logits run in fp32. Attention goes
through the flash kernels (ops/attention.py) by default, forward and
gradient; `remat=True` recomputes each layer in the backward
(torch.utils.checkpoint), as the JAX package's jax.checkpoint does. A
config with experts runs the MoE FFN (models/moe.py) in place of the dense
one on every layer, on one device.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops.attention import flash_attention
from .moe import init_moe_layer, moe_ffn, normal_init


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_dim: int = 11008
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 4096
    dtype: str = "bfloat16"
    # MoE (0 experts = dense FFN)
    num_experts: int = 0
    experts_per_token: int = 2
    expert_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # Mistral-class sliding-window attention: each token attends to the
    # last `sliding_window` positions only (None = full causal)
    sliding_window: int | None = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def llama2_7b(cls) -> "LlamaConfig":
        return cls()  # defaults are the 7B shape

    @classmethod
    def tiny(cls, vocab: int = 256) -> "LlamaConfig":
        """Test shape: every code path, a few layers, narrow widths."""
        return cls(vocab_size=vocab, dim=128, n_layers=2, n_heads=4,
                   n_kv_heads=2, ffn_dim=256, max_seq_len=512)

    @classmethod
    def tiny_moe(cls, vocab: int = 256) -> "LlamaConfig":
        """tiny() with a 4-expert top-2 MoE FFN."""
        return cls(vocab_size=vocab, dim=128, n_layers=2, n_heads=4,
                   n_kv_heads=2, ffn_dim=256, max_seq_len=512, num_experts=4)


# ---------------------------------------------------------------------- init
def init_llama(config: LlamaConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters from `seed`, made on `device` in the config's dtype
    (norm weights fp32), with the JAX package's distributions: N(0, 1) /
    sqrt(fan_in) drawn in fp32 and cast. A config with experts gets the
    MoE leaves (`init_moe_layer`) in place of w_gate, w_up and w_down."""
    dev = resolve_device(device)
    dt = config.torch_dtype
    d, f, hd = config.dim, config.ffn_dim, config.head_dim
    h, kvh = config.n_heads, config.n_kv_heads
    gen = torch.Generator(device=dev).manual_seed(seed)

    def norm_init(fan_in, shape):
        return normal_init(shape, fan_in, dt, gen, dev)

    def ones():
        return torch.ones((d,), device=dev, dtype=torch.float32)

    def ffn():
        if config.is_moe:
            return init_moe_layer(d, f, config.num_experts, dt, gen, dev)
        return {"w_gate": norm_init(d, (d, f)), "w_up": norm_init(d, (d, f)),
                "w_down": norm_init(f, (f, d))}

    embed = norm_init(1.0, (config.vocab_size, d))
    layers = [{
        "attn_norm": ones(),
        "wq": norm_init(d, (d, h * hd)),
        "wk": norm_init(d, (d, kvh * hd)),
        "wv": norm_init(d, (d, kvh * hd)),
        "wo": norm_init(h * hd, (h * hd, d)),
        "mlp_norm": ones(),
        **ffn(),
    } for _ in range(config.n_layers)]
    return {"embed": embed, "layers": layers, "final_norm": ones(),
            "lm_head": norm_init(d, (d, config.vocab_size))}


# ------------------------------------------------------------------- pieces
def rms_norm(x, weight, eps: float):
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rms * weight).to(x.dtype)


def rotary(x, theta: float, positions=None):
    """Interleaved RoPE on [B, S, H, hd] (pairs (0,1), (2,3), ...; fp32
    inside). `positions` [B, S] gives absolute token positions (KV-cache
    decode); None means 0..S-1."""
    b, s, h, hd = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device, dtype=torch.float32)[None, :]
    inv_freq = 1.0 / (theta ** (torch.arange(0, hd, 2, device=x.device,
                                             dtype=torch.float32) / hd))
    angles = positions.float()[..., None] * inv_freq  # [B?, S, hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(b, s, h, hd).to(x.dtype)


def _handles_gqa(impl) -> bool:
    """Does this attention impl accept k/v with fewer heads than q?
    (functools.partial wrappers are looked through)."""
    return bool(getattr(impl, "handles_gqa",
                        getattr(getattr(impl, "func", None),
                                "handles_gqa", False)))


def _attention_block(x, layer, config: LlamaConfig, attn_impl):
    b, s, _ = x.shape
    h, kvh, hd = config.n_heads, config.n_kv_heads, config.head_dim
    xn = rms_norm(x, layer["attn_norm"], config.norm_eps)
    q = (xn @ layer["wq"]).view(b, s, h, hd)
    k = (xn @ layer["wk"]).view(b, s, kvh, hd)
    v = (xn @ layer["wv"]).view(b, s, kvh, hd)
    q = rotary(q, config.rope_theta)
    k = rotary(k, config.rope_theta)
    if kvh != h and not _handles_gqa(attn_impl):
        # GQA broadcast for attention impls that need equal head counts
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    # [B, S, H, hd] -> [B, H, S, hd] views; the kernel reads the strides
    o = attn_impl(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    o = o.transpose(1, 2).reshape(b, s, h * hd)
    return x + o @ layer["wo"]


def _mlp_block(x, layer, config: LlamaConfig):
    """Dense or MoE FFN with residual; returns (y, aux), aux the MoE
    load-balance loss (a 0-d tensor), 0.0 for the dense FFN."""
    xn = rms_norm(x, layer["mlp_norm"], config.norm_eps)
    if config.is_moe:
        y, aux = moe_ffn(xn, layer, config.num_experts,
                         config.experts_per_token,
                         config.expert_capacity_factor)
        return x + y, aux
    gate = torch.nn.functional.silu((xn @ layer["w_gate"]).float()).to(x.dtype)
    return x + (gate * (xn @ layer["w_up"])) @ layer["w_down"], 0.0


def transformer_layer(x, layer, config: LlamaConfig, attn_impl):
    """One decoder layer: attention + (dense|MoE) FFN. Returns (y, aux)."""
    y = _attention_block(x, layer, config, attn_impl)
    return _mlp_block(y, layer, config)


# ------------------------------------------------------------------ forward
def llama_forward(params: dict, tokens, config: LlamaConfig, attn_impl=None,
                  remat: bool = False, return_aux: bool = False, moe_part=None):
    """tokens [B, S] (integer) -> logits [B, S, vocab] (fp32); with
    return_aux, -> (logits, aux), where aux is the mean per-layer MoE
    load-balance loss (0.0 for the dense model). `remat` recomputes each
    layer's activations in the backward instead of keeping them (the
    attention forward kernel runs a second time per layer). `moe_part`, the
    JAX package's expert-parallel sharding hook, must be None: one device."""
    if moe_part is not None:
        raise NotImplementedError(
            "moe_part (the expert-parallel sharding hook) is not ported to "
            "PyTorch yet: it comes with the mesh, ROADMAP.md queue 1 items 7-8")
    if attn_impl is None:
        attn_impl = partial(flash_attention, causal=True,
                            window=config.sliding_window)
    elif config.sliding_window is not None:
        # a custom impl would silently ignore the window and attend
        # globally: refuse rather than diverge from the config
        raise ValueError(
            "sliding_window requires the default flash attention impl; "
            "custom attn_impl callers must apply the window themselves")
    x = params["embed"][tokens]
    aux = 0.0
    for layer in params["layers"]:
        if remat:
            # the layer draws no random numbers, so no RNG state is kept
            x, a = checkpoint(transformer_layer, x, layer, config, attn_impl,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = transformer_layer(x, layer, config, attn_impl)
        aux = aux + a
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    logits = (x @ params["lm_head"]).float()
    if return_aux:
        return logits, aux / config.n_layers
    return logits


def llama_loss(params: dict, tokens, config: LlamaConfig, attn_impl=None,
               remat: bool = False, moe_part=None):
    """Next-token cross-entropy over tokens [B, S], differentiable through
    the attention kernels on CUDA and the plain attention on the CPU. The
    final position is masked rather than sliced off, as in the JAX package.
    The MoE load-balance term, weighted by `moe_aux_weight`, is 0.0 for the
    dense model."""
    b, s = tokens.shape
    logits, aux = llama_forward(params, tokens, config, attn_impl, remat,
                                return_aux=True, moe_part=moe_part)
    targets = torch.roll(tokens, -1, dims=1).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    mask = (torch.arange(s, device=nll.device) < s - 1).to(nll.dtype)[None, :]
    return torch.sum(nll * mask) / (b * (s - 1)) + config.moe_aux_weight * aux
