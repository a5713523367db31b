"""Autoregressive generation for the Llama workload: prefill + KV-cache
decode in PyTorch.

The port of yoda_scheduler_tpu/models/generate.py. The KV cache is a
pre-allocated [L, B, max_len, kvH, D] buffer storing the kv heads only (GQA
broadcast happens at attention time). Prefill runs the prompt through the
layers once and seeds the cache; decode steps are [B, 1] queries against
the cache with explicit length masking. Attention against the cache is
plain PyTorch (`_cached_attention`), as it is plain XLA in the JAX package.

Cache writes are in place (slice assignment where the JAX package uses
`dynamic_update_slice` on an immutable buffer): the cache a step returns
shares its buffers with the cache it was given, which is spent. The cache
length is a Python int, so the overflow check always runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch

from .._device import resolve_device
from .llama import LlamaConfig, _mlp_block, rms_norm, rotary


@dataclass(frozen=True)
class KVCache:
    """Per-layer stacked K/V buffers + current length (static max size)."""
    k: torch.Tensor  # [L, B, max_len, kvH, D]
    v: torch.Tensor
    length: int      # valid prefix length

    @classmethod
    def zeros(cls, config: LlamaConfig, batch: int, max_len: int,
              device="cuda") -> "KVCache":
        dev = resolve_device(device)
        shape = (config.n_layers, batch, max_len, config.n_kv_heads,
                 config.head_dim)
        dt = config.torch_dtype
        return cls(k=torch.zeros(shape, dtype=dt, device=dev),
                   v=torch.zeros(shape, dtype=dt, device=dev), length=0)


def _cached_attention(q, k_cache, v_cache, q_positions, cache_len,
                      window: int | None = None, k_positions=None):
    """q [B, Sq, H, D] against cache [B, max_len, kvH, D]; causal against
    absolute positions; `window` applies the model's sliding window. The
    linear cache passes `cache_len` (slot i holds position i, masked beyond
    the valid prefix); the ring cache passes `k_positions` [max_len] (each
    slot's absolute position, -1 = never written). Returns [B, Sq, H, D]."""
    _, _, h, d = q.shape
    kvh = k_cache.shape[2]
    if kvh != h:  # GQA broadcast at attention time
        k_cache = k_cache.repeat_interleave(h // kvh, dim=2)
        v_cache = v_cache.repeat_interleave(h // kvh, dim=2)
    scale = 1.0 / (d ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float()) * scale
    if k_positions is None:
        k_pos = torch.arange(k_cache.shape[1], device=q.device)
        valid = k_pos < cache_len
    else:
        k_pos = k_positions
        valid = k_pos >= 0
    k_pos = k_pos[None, None, None, :]
    q_pos = q_positions[:, None, :, None]
    mask = (k_pos <= q_pos) & valid[None, None, None, :]
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v_cache.float())
    return o.to(q.dtype)


def _run_layers(params, tokens, positions, k_all, v_all, write_at: int,
                config: LlamaConfig, cache_len=None, k_positions=None):
    """The shared decode/prefill layer walk: project QKV at `positions`,
    write K/V into each layer's buffer at slot `write_at` (in place), attend
    against the buffer (linear mask via `cache_len`, ring mask via
    `k_positions`: exactly one is given), residual + FFN. Returns
    (logits [B, S, vocab], k_all, v_all)."""
    x = params["embed"][tokens]
    b, s, _ = x.shape
    h, kvh, hd = config.n_heads, config.n_kv_heads, config.head_dim
    for i, layer in enumerate(params["layers"]):
        xn = rms_norm(x, layer["attn_norm"], config.norm_eps)
        q = (xn @ layer["wq"]).view(b, s, h, hd)
        k = (xn @ layer["wk"]).view(b, s, kvh, hd)
        v = (xn @ layer["wv"]).view(b, s, kvh, hd)
        q = rotary(q, config.rope_theta, positions)
        k = rotary(k, config.rope_theta, positions)
        k_all[i, :, write_at:write_at + s] = k
        v_all[i, :, write_at:write_at + s] = v
        o = _cached_attention(q, k_all[i], v_all[i], positions, cache_len,
                              window=config.sliding_window,
                              k_positions=k_positions)
        x = x + o.reshape(b, s, h * hd) @ layer["wo"]
        # same FFN as the forward; an MoE layer takes its capacity from this
        # call's own S (the prompt at prefill, 1 at decode)
        x, _ = _mlp_block(x, layer, config)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    logits = (x @ params["lm_head"]).float()
    return logits, k_all, v_all


def _forward_with_cache(params, tokens, positions, cache: KVCache,
                        config: LlamaConfig):
    """Run tokens [B, S] at absolute `positions` [B, S], reading + appending
    to the cache at [cache.length, cache.length + S). Returns
    (logits [B, S, vocab], new cache)."""
    max_len = cache.k.shape[2]
    if cache.length + tokens.shape[1] > max_len:
        raise ValueError(
            f"KV cache full: length {cache.length} + "
            f"{tokens.shape[1]} new > max_len {max_len}")
    new_len = cache.length + tokens.shape[1]
    logits, new_k, new_v = _run_layers(
        params, tokens, positions, cache.k, cache.v, cache.length, config,
        cache_len=new_len)
    return logits, KVCache(k=new_k, v=new_v, length=new_len)


def _positions(start: int, b: int, s: int, device) -> torch.Tensor:
    return (torch.arange(s, device=device) + start).expand(b, s)


def prefill(params, tokens, cache: KVCache, config: LlamaConfig):
    """Seed the cache with a prompt [B, S]; returns (last-token logits
    [B, vocab], cache)."""
    b, s = tokens.shape
    positions = _positions(cache.length, b, s, tokens.device)
    logits, cache = _forward_with_cache(params, tokens, positions, cache,
                                        config)
    return logits[:, -1], cache


def decode_step(params, token, cache: KVCache, config: LlamaConfig):
    """One decode step: token [B] -> (logits [B, vocab], cache)."""
    positions = _positions(cache.length, token.shape[0], 1, token.device)
    logits, cache = _forward_with_cache(params, token[:, None], positions,
                                        cache, config)
    return logits[:, 0], cache


# ------------------------------------------------- rolling (ring) KV cache
@dataclass(frozen=True)
class RollingKVCache:
    """Ring-buffer cache for sliding-window models: `window` slots per
    layer instead of prompt+generated, so decode memory stays O(window).
    `slot_pos[w]` holds the absolute position stored in slot w (-1 = never
    written); position p lives in slot p % window."""
    k: torch.Tensor         # [L, B, window, kvH, D]
    v: torch.Tensor
    slot_pos: torch.Tensor  # [window] int64
    next_pos: int           # next absolute position to write

    @classmethod
    def from_prefill(cls, cache: KVCache, window: int) -> "RollingKVCache":
        """Fold a freshly prefilled full cache (length == prompt length)
        into the ring: only the last `window` positions can be attended
        again under the sliding window."""
        max_len = cache.k.shape[2]
        dev = cache.k.device
        # the last `window` absolute positions ending at length-1 (negatives
        # mark not-yet-written slots for short prompts). The slot index comes
        # from the unclipped positions: W consecutive integers are distinct
        # mod W, so every slot is written once; the clipped gather index
        # would hit slot 0 many times for short prompts
        abs_pos = cache.length - window + torch.arange(window, device=dev)
        slot = abs_pos % window
        gather = abs_pos.clamp(0, max_len - 1)
        k = cache.k.new_zeros(cache.k.shape[:2] + (window,) + cache.k.shape[3:])
        v = torch.zeros_like(k)
        k[:, :, slot] = cache.k[:, :, gather]
        v[:, :, slot] = cache.v[:, :, gather]
        slot_pos = torch.zeros(window, dtype=torch.int64, device=dev)
        slot_pos[slot] = torch.where(abs_pos >= 0, abs_pos, -1)
        return cls(k=k, v=v, slot_pos=slot_pos, next_pos=cache.length)


def decode_step_rolling(params, token, cache: RollingKVCache,
                        config: LlamaConfig):
    """One decode step against the ring: token [B] -> (logits [B, vocab],
    cache). Requires config.sliding_window == the cache's window size."""
    window = cache.k.shape[2]
    if config.sliding_window != window:
        raise ValueError(
            f"rolling cache window {window} != config.sliding_window "
            f"{config.sliding_window}")
    p = cache.next_pos
    slot = p % window
    positions = _positions(p, token.shape[0], 1, token.device)
    # every layer writes the same slot: update slot_pos once (in place). The
    # layer walk masks by the ring's absolute positions: valid slots hold
    # p-window < pos <= p, never-written slots carry -1
    cache.slot_pos[slot] = p
    logits, new_k, new_v = _run_layers(
        params, token[:, None], positions, cache.k, cache.v, slot, config,
        k_positions=cache.slot_pos)
    return logits[:, 0], RollingKVCache(k=new_k, v=new_v,
                                        slot_pos=cache.slot_pos,
                                        next_pos=p + 1)


def _pick(logits, temperature: float, generator):
    """Greedy argmax at temperature 0, else a categorical sample (Gumbel-max
    over logits / temperature). Temperature is a plain runtime value."""
    if temperature > 0.0:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device, dtype=torch.float32)
        return torch.argmax(logits / temperature - torch.log(-torch.log(u)),
                            dim=-1)
    return torch.argmax(logits, dim=-1)


@torch.no_grad()
def generate(params, prompt, config: LlamaConfig, max_new_tokens: int,
             temperature: float = 0.0, generator: torch.Generator | None = None,
             max_len: int | None = None, rolling: bool | None = None,
             eager: bool = False):
    """Generate `max_new_tokens` continuations of prompt [B, S].

    temperature 0 = greedy argmax; > 0 = categorical sampling (requires
    `generator`, a torch.Generator on the params' device). Returns
    [B, max_new_tokens] int64.

    `rolling` (sliding-window models only): decode against a ring buffer of
    `sliding_window` slots instead of a prompt+generated-sized cache, with
    identical outputs. Default: rolling whenever the window is smaller than
    prompt + new tokens.

    `eager` is accepted for the JAX package's signature: the decode loop is
    a Python loop either way, so both values give the same tokens."""
    del eager
    b, s = prompt.shape
    max_len = max_len or (s + max_new_tokens)
    if max_len < s + max_new_tokens:
        raise ValueError(
            f"max_len {max_len} < prompt {s} + new {max_new_tokens}")
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) requires `generator`")
    window = config.sliding_window
    if rolling is None:
        rolling = window is not None and window < s + max_new_tokens
    if rolling and window is None:
        raise ValueError("rolling cache requires config.sliding_window")
    device = params["embed"].device
    if rolling:
        pre = KVCache.zeros(config, b, s, device=device)  # then discarded
        logits, pre = prefill(params, prompt, pre, config)
        cache = RollingKVCache.from_prefill(pre, window)
        step_fn = decode_step_rolling
    else:
        cache = KVCache.zeros(config, b, max_len, device=device)
        logits, cache = prefill(params, prompt, cache, config)
        step_fn = decode_step
    toks = []
    for i in range(max_new_tokens):
        tok = _pick(logits, temperature, generator)
        toks.append(tok)
        if i + 1 < max_new_tokens:  # the last token needs no forward
            logits, cache = step_fn(params, tok, cache, config)
    if not toks:
        return torch.zeros((b, 0), dtype=torch.int64, device=device)
    return torch.stack(toks, dim=1)


def make_generate_fn(config: LlamaConfig, max_new_tokens: int,
                     temperature: float = 0.0):
    """generate with config, length and temperature bound (the serving
    entry)."""
    return partial(generate, config=config, max_new_tokens=max_new_tokens,
                   temperature=temperature)
