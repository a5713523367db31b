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
one on every layer.

`plan` says how the layers see their weights and their neighbours: None is
one device (`OneDevice`); parallel/sharding.py's `ShardPlan` runs the same
layers on one rank of a mesh, where GSPMD partitions the same program for
the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

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


class OneDevice:
    """The model's hooks on one device: every weight whole, every collective
    the identity, positions 0..S-1. A sharded plan (parallel/sharding.py)
    overrides them for one rank's shards: it gathers weights at use, sums
    tensor-parallel partial products, offsets positions by the rank's
    sequence chunk and reduces the loss over the vocabulary's shards."""

    moe_part = None  # the expert-parallel hook of models/moe.py:moe_ffn

    def attention(self, config: LlamaConfig):
        """The model's own attention: causal flash attention, with the
        config's window."""
        return partial(flash_attention, causal=True, window=config.sliding_window)

    def heads(self, config: LlamaConfig) -> int:
        """The query heads of this rank."""
        return config.n_heads

    def leaf(self, name: str, t):
        """A top-level leaf (embed, final_norm, lm_head) at use."""
        return t

    def layer(self, layer: dict) -> dict:
        """One layer's leaves at use."""
        return layer

    def tp_in(self, x):
        """The input of a column-parallel product."""
        return x

    def tp_out(self, x):
        """The output of a row-parallel product."""
        return x

    def positions(self, s: int, device):
        """Absolute positions of this rank's s tokens [1, s] (None: 0..s-1)."""
        return None

    def kv_heads(self, t):
        """k or v [B, S, kvh', hd] as this rank's query heads read them."""
        return t

    def targets(self, tokens):
        """Each position's next token (the last wraps, and is masked)."""
        return torch.roll(tokens, -1, dims=1).long()

    def nll(self, logits, targets):
        """-log softmax(logits)[target] in fp32."""
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, targets[..., None])[..., 0]

    def global_shape(self, b: int, s: int) -> tuple[int, int]:
        """The batch and sequence of the whole step from this rank's."""
        return b, s


ONE_DEVICE = OneDevice()


def _handles_gqa(impl) -> bool:
    """Does this attention impl accept k/v with fewer heads than q?
    (functools.partial wrappers are looked through)."""
    return bool(getattr(impl, "handles_gqa",
                        getattr(getattr(impl, "func", None),
                                "handles_gqa", False)))


def _attention_block(x, layer, config: LlamaConfig, attn_impl, plan=ONE_DEVICE):
    b, s, _ = x.shape
    h, hd = plan.heads(config), config.head_dim
    xn = plan.tp_in(rms_norm(x, layer["attn_norm"], config.norm_eps))
    q = (xn @ layer["wq"]).view(b, s, h, hd)
    k = (xn @ layer["wk"]).view(b, s, -1, hd)
    v = (xn @ layer["wv"]).view(b, s, -1, hd)
    positions = plan.positions(s, x.device)
    q = rotary(q, config.rope_theta, positions)
    k = plan.kv_heads(rotary(k, config.rope_theta, positions))
    v = plan.kv_heads(v)
    kvh = k.shape[2]
    if kvh != h and not _handles_gqa(attn_impl):
        # GQA broadcast for attention impls that need equal head counts
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    # [B, S, H, hd] -> [B, H, S, hd] views; the kernel reads the strides
    o = attn_impl(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    o = o.transpose(1, 2).reshape(b, s, h * hd)
    return x + plan.tp_out(o @ layer["wo"])


def _mlp_block(x, layer, config: LlamaConfig, moe_part=None, plan=ONE_DEVICE):
    """Dense or MoE FFN with residual; returns (y, aux), aux the MoE
    load-balance loss (a 0-d tensor), 0.0 for the dense FFN."""
    xn = rms_norm(x, layer["mlp_norm"], config.norm_eps)
    if config.is_moe:
        y, aux = moe_ffn(xn, layer, config.num_experts,
                         config.experts_per_token,
                         config.expert_capacity_factor, part=moe_part)
        return x + y, aux
    xn = plan.tp_in(xn)
    gate = torch.nn.functional.silu((xn @ layer["w_gate"]).float()).to(x.dtype)
    return x + plan.tp_out((gate * (xn @ layer["w_up"])) @ layer["w_down"]), 0.0


def transformer_layer(x, layer, config: LlamaConfig, attn_impl, moe_part=None,
                      plan=ONE_DEVICE):
    """One decoder layer: attention + (dense|MoE) FFN. Returns (y, aux).
    `layer` holds the leaves as the plan gives them at use."""
    y = _attention_block(x, layer, config, attn_impl, plan)
    return _mlp_block(y, layer, config, moe_part, plan)


def _plan_layer(x, layer, config, attn_impl, moe_part, plan):
    """transformer_layer on the plan's view of the layer's leaves, so that
    under remat the gathered weights are freed after the layer and gathered
    again in its recomputation."""
    return transformer_layer(x, plan.layer(layer), config, attn_impl, moe_part, plan)


# ------------------------------------------------------------------ forward
def run_layers(layers: list, x, config: LlamaConfig, attn_impl, remat: bool = False,
               moe_part=None, plan=ONE_DEVICE):
    """x [B, S, d] through `layers` in order -> (x, aux), aux the sum of the
    layers' MoE load-balance losses (0.0 for the dense model). `remat`
    recomputes each layer's activations in the backward instead of keeping
    them."""
    aux = 0.0
    for layer in layers:
        if remat:
            # the layer draws no random numbers, so no RNG state is kept;
            # the whole layer is recomputed (no early stop), so that every
            # rank runs each of its collectives again
            with set_checkpoint_early_stop(False):
                x, a = checkpoint(_plan_layer, x, layer, config, attn_impl, moe_part,
                                  plan, use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = _plan_layer(x, layer, config, attn_impl, moe_part, plan)
        aux = aux + a
    return x, aux


def final_logits(params: dict, x, config: LlamaConfig, plan=ONE_DEVICE):
    """The last hidden states [B, S, d] -> fp32 logits (final norm, lm head)."""
    x = rms_norm(x, plan.leaf("final_norm", params["final_norm"]), config.norm_eps)
    return (plan.tp_in(x) @ plan.leaf("lm_head", params["lm_head"])).float()


def llama_forward(params: dict, tokens, config: LlamaConfig, attn_impl=None,
                  remat: bool = False, return_aux: bool = False, moe_part=None,
                  plan=None):
    """tokens [B, S] (integer) -> logits [B, S, vocab] (fp32); with
    return_aux, -> (logits, aux), where aux is the mean per-layer MoE
    load-balance loss (0.0 for the dense model). `remat` recomputes each
    layer's activations in the backward instead of keeping them (the
    attention forward kernel runs a second time per layer). `moe_part` is
    the expert-parallel hook (models/moe.py:moe_ffn's `part`; also given the
    embedding table, "table", and its lookup, "combine", as in the JAX
    package); None takes the plan's. `plan` None is one device; a sharded
    plan (parallel/sharding.py:ShardPlan) gives this rank's tokens [B', S']
    and params, and the logits are this rank's [B', S', vocab'] shard."""
    plan = plan or ONE_DEVICE
    moe_part = moe_part or plan.moe_part
    if attn_impl is None:
        attn_impl = plan.attention(config)
    elif config.sliding_window is not None:
        # a custom impl would silently ignore the window and attend
        # globally: refuse rather than diverge from the config
        raise ValueError(
            "sliding_window requires the default flash attention impl; "
            "custom attn_impl callers must apply the window themselves")
    table = plan.leaf("embed", params["embed"])
    if moe_part is not None:
        x = moe_part(moe_part(table, "table")[tokens], "combine")
    else:
        x = table[tokens]
    x, aux = run_layers(params["layers"], x, config, attn_impl, remat, moe_part, plan)
    logits = final_logits(params, x, config, plan)
    if return_aux:
        return logits, aux / config.n_layers
    return logits


def ce_share(logits, tokens, plan=ONE_DEVICE):
    """This rank's share of the next-token cross-entropy: its tokens' sum
    over the whole step's B (S - 1) (on one device the mean). The final
    position of each row is masked rather than sliced off, as in the JAX
    package."""
    b, s = tokens.shape
    nll = plan.nll(logits, plan.targets(tokens))
    b_all, s_all = plan.global_shape(b, s)
    positions = plan.positions(s, nll.device)
    if positions is None:
        positions = torch.arange(s, device=nll.device)
    mask = (positions < s_all - 1).to(nll.dtype).view(1, s)
    return torch.sum(nll * mask) / (b_all * (s_all - 1))


def loss_terms(params: dict, tokens, config: LlamaConfig, attn_impl=None,
               remat: bool = False, moe_part=None, plan=None):
    """-> (ce, aux): this rank's share of the next-token cross-entropy
    (`ce_share`) and the MoE load-balance loss over the whole step (0.0 for
    the dense model)."""
    plan = plan or ONE_DEVICE
    logits, aux = llama_forward(params, tokens, config, attn_impl, remat,
                                return_aux=True, moe_part=moe_part, plan=plan)
    return ce_share(logits, tokens, plan), aux


def llama_loss(params: dict, tokens, config: LlamaConfig, attn_impl=None,
               remat: bool = False, moe_part=None, plan=None):
    """Next-token cross-entropy over tokens [B, S] plus the MoE load-balance
    term weighted by `moe_aux_weight` (0.0 for the dense model),
    differentiable through the attention kernels on CUDA and the plain
    attention on the CPU. With a sharded `plan`, this rank's share: the
    step's loss is the sum of the cross-entropy shares over the ranks that
    split the tokens, plus the weighted aux once (`loss_terms`)."""
    ce, aux = loss_terms(params, tokens, config, attn_impl, remat, moe_part, plan)
    return ce + config.moe_aux_weight * aux
