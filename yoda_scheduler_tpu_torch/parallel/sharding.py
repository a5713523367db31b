"""Sharding rules for the Llama parameters and tokens over a rank mesh, and
the plan that runs the model's layers on one rank's shards.

The port of yoda_scheduler_tpu/parallel/sharding.py. The scheme is the same
Megatron-style column/row split on tp with FSDP-style weight sharding on
fsdp and the experts on ep. A spec is a tuple with one entry per dimension:
None, an axis name or a tuple of axis names (split major to minor). The
port's layers are a list of per-layer dicts, so a layer leaf's spec has no
leading (stacked-layer) entry: the spec of the list itself is "layer_list"
(None: every rank holds every layer; "pp" in the pipeline's specs). Where
the JAX package hands its specs to GSPMD, `ShardPlan` inserts the
collectives itself (parallel/collectives.py).
"""

from __future__ import annotations

import torch

from ..models.llama import LlamaConfig, OneDevice
from ..models.moe import ExpertHooks
from ..ops.attention import flash_attention
from . import collectives as C
from .mesh import DATA_AXES


def llama_param_specs(config=None) -> dict:
    """Spec of each parameter: the top-level leaves, and one layer's under
    "layers". With a MoE config, the FFN entries are the expert-stacked
    mats, whose expert axis shards over `ep` (tp still splits within each
    expert)."""
    if config is not None and getattr(config, "is_moe", False):
        ffn = {
            "router": ("fsdp", None),            # [d, E]
            "we_gate": ("ep", "fsdp", "tp"),     # [E, d, f]
            "we_up": ("ep", "fsdp", "tp"),
            "we_down": ("ep", "tp", "fsdp"),     # [E, f, d]
        }
    else:
        ffn = {
            "w_gate": ("fsdp", "tp"),  # [d, f]
            "w_up": ("fsdp", "tp"),
            "w_down": ("tp", "fsdp"),  # [f, d]
        }
    return {
        "embed": (None, "fsdp"),       # [vocab, d]
        "layers": {
            "attn_norm": (None,),      # [d]
            "wq": ("fsdp", "tp"),      # [d, h*hd]   column-parallel
            "wk": ("fsdp", "tp"),
            "wv": ("fsdp", "tp"),
            "wo": ("tp", "fsdp"),      # [h*hd, d]   row-parallel
            "mlp_norm": (None,),
            **ffn,
        },
        "final_norm": (None,),
        "lm_head": ("fsdp", "tp"),     # [d, vocab]
        "layer_list": None,            # the list of layers, whole on every rank
    }


def batch_spec(sp: bool = False) -> tuple:
    """tokens [B, S]: batch over dp+fsdp+ep (tokens shard over the expert
    axis too, so non-expert compute is never replicated across ep groups;
    the dispatch all-to-all is ep's only communication); seq over sp when
    sequence parallelism is on."""
    return (("dp", "fsdp", "ep"), "sp" if sp else None)


def _axes(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def shard(t, spec: tuple, mesh):
    """This rank's shard of the whole tensor `t` under `spec` (a copy that
    owns its storage; `t` itself where nothing is split)."""
    out = t
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        axis = mesh.axis(axes)
        if axis.size == 1:
            continue
        if t.shape[dim] % axis.size:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not split "
                             f"over {axes} of size {axis.size}")
        out = out.chunk(axis.size, dim)[axis.index]
    return out if out is t else out.clone()


def gather(t, spec: tuple, mesh):
    """The whole tensor from every rank's shard under `spec` (no gradient)."""
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if axes:
            t = C.gather_values(t, dim, mesh.axis(axes))
    return t


def _map_params(fn, params: dict, specs: dict) -> dict:
    top = {n: fn(params[n], specs[n]) for n in ("embed", "final_norm", "lm_head")}
    return {**top, "layers": [{n: fn(t, specs["layers"][n]) for n, t in layer.items()}
                              for layer in params["layers"]]}


def _layer_list_axis(specs: dict, mesh):
    """The mesh axis that splits the list of layers (None: not split)."""
    axes = _axes(specs["layer_list"])
    return mesh.axis(axes) if axes and mesh.size(axes) > 1 else None


def shard_params(params: dict, mesh, config=None, specs=None) -> dict:
    """Whole port parameters -> this rank's shards (`specs`, by default
    `llama_param_specs`); where "layer_list" names an axis, this rank's
    contiguous block of the layers, rank i of n holding layers [i L/n,
    (i + 1) L/n)."""
    specs = specs or llama_param_specs(config)
    layers = params["layers"]
    axis = _layer_list_axis(specs, mesh)
    if axis is not None:
        if len(layers) % axis.size:
            raise ValueError(f"{len(layers)} layers do not split over "
                             f"{specs['layer_list']} of size {axis.size}")
        n = len(layers) // axis.size
        layers = layers[axis.index * n:(axis.index + 1) * n]
    return _map_params(lambda t, spec: shard(t.detach(), spec, mesh),
                       {**params, "layers": layers}, specs)


def gather_params(local: dict, mesh, config=None, specs=None) -> dict:
    """The inverse of `shard_params`: every rank's shards -> the whole
    parameters, on every rank (for tests and checkpoint-free comparison)."""
    specs = specs or llama_param_specs(config)
    whole = _map_params(lambda t, spec: gather(t.detach(), spec, mesh), local, specs)
    axis = _layer_list_axis(specs, mesh)
    if axis is not None:
        layers = whole["layers"]
        stacked = {n: C.gather_values(torch.stack([layer[n] for layer in layers]), 0, axis)
                   for n in layers[0]}
        whole["layers"] = [{n: t[i] for n, t in stacked.items()}
                           for i in range(len(layers) * axis.size)]
    return whole


def grad_axes(spec: tuple) -> tuple:
    """The axes over which the gradient of a leaf with `spec` is summed after
    the backward: the data axes its spec does not name. fsdp's sum is the
    reduce-scatter of the gather at use and ep's the inverse all-to-all of
    the dispatch; tp-replicated work gives every tp rank the same gradient."""
    named = {a for entry in spec for a in _axes(entry)}
    return tuple(a for a in DATA_AXES if a not in named)


class _ShardedExperts(ExpertHooks):
    """The expert-parallel hook: the JAX package's `_make_moe_part` roles
    as data movement. "dispatch": the expert batch [E, B, C, d] goes over ep
    to the experts' owners (all-to-all: [E/ep, ep B, C, d]), then into the
    column-parallel products (tp splits f); "expert_out": the row-parallel
    partial outputs summed over tp, then back (the inverse all-to-all).
    "hidden", "combine" and "table" stay local (the plan gathers the table).
    Routing sees the step: capacity from the row's whole length, queues
    across the sequence's chunks, the aux loss over every token."""

    def __init__(self, mesh):
        super().__init__()
        self.ep, self.tp = mesh.axis("ep"), mesh.axis("tp")
        self.sp, self.tokens = mesh.axis("sp"), mesh.axis(DATA_AXES)

    def __call__(self, t, role):
        if role == "dispatch":
            return C.fan_out(C.all_to_all(t, 0, 1, self.ep), self.tp)
        if role == "expert_out":
            return C.all_to_all(C.sum_partials(t, self.tp), 1, 0, self.ep)
        return t

    def seq_len(self, s):
        return s * self.sp.size

    def queue_offsets(self, counts):
        # counts [B, E, k] of every sequence chunk of the row: the choices
        # of earlier slots anywhere, and of this slot in earlier chunks
        every = C.gather_values(counts[None], 0, self.sp)
        total = every.sum(0)
        return total.cumsum(-1) - total + every[:self.sp.index].sum(0)

    def token_sum(self, t):
        return C.sum_partials(t, self.tokens)

    def token_count(self, n):
        return n * self.tokens.size


class ShardPlan(OneDevice):
    """The model's hooks (models/llama.py:OneDevice) for one rank of `mesh`:
    fsdp weights gathered at use (per layer, inside remat), Megatron tp
    (column-parallel q/k/v, gate/up and lm_head; row-parallel wo and down),
    the sequence chunk's global positions and next tokens over sp, the
    vocabulary-parallel log-softmax over tp, and the expert hook over ep.
    On a mesh of size 1 every hook is the one-device one."""

    def __init__(self, config: LlamaConfig, mesh):
        self.config, self.mesh = config, mesh
        self.specs = llama_param_specs(config)
        self.tp, self.sp = mesh.axis("tp"), mesh.axis("sp")
        self.batch = mesh.axis(("dp", "fsdp", "ep"))
        if config.n_heads % self.tp.size:
            raise ValueError(f"{config.n_heads} heads do not split over tp="
                             f"{self.tp.size}")
        # kv heads that do not split over tp: each rank computes them all
        self.kv_whole = config.n_kv_heads % self.tp.size != 0
        self.moe_part = _ShardedExperts(mesh) if config.is_moe else None

    def _at_use(self, t, spec):
        """Gather the fsdp (and for whole kv heads, tp) split of a leaf."""
        for dim, entry in enumerate(spec):
            axes = tuple(a for a in _axes(entry) if a == "fsdp")
            if axes:
                t = C.all_gather(t, dim, self.mesh.axis(axes))
        return t

    def attention(self, config):
        """Over sp without a ring: this chunk's queries against the keys and
        values of every chunk up to its own, gathered over sp (the kernel
        aligns the queries to the end of the keys)."""
        if self.sp.size == 1:
            return super().attention(config)
        sp, window = self.sp, config.sliding_window

        def gathered(q, k, v):
            upto = (sp.index + 1) * q.shape[2]
            k = C.all_gather(k, 2, sp)[:, :, :upto]
            v = C.all_gather(v, 2, sp)[:, :, :upto]
            return flash_attention(q, k, v, causal=True, window=window)

        gathered.handles_gqa = True
        return gathered

    def heads(self, config):
        return config.n_heads // self.tp.size

    def leaf(self, name, t):
        return self._at_use(t, self.specs[name])

    def layer(self, layer):
        out = {n: self._at_use(t, self.specs["layers"][n]) for n, t in layer.items()}
        if self.kv_whole:
            for n in ("wk", "wv"):
                out[n] = C.all_gather(out[n], 1, self.tp)
        return out

    def tp_in(self, x):
        return C.fan_out(x, self.tp)

    def tp_out(self, x):
        return C.sum_partials(x, self.tp)

    def positions(self, s, device):
        if self.sp.size == 1:
            return None
        return (self.sp.index * s + torch.arange(s, device=device,
                                                 dtype=torch.float32))[None, :]

    def kv_heads(self, t):
        """Whole kv heads (they do not split over tp): repeated to full heads
        (the JAX ring's broadcast, before GQA) and cut to this rank's."""
        if not self.kv_whole:
            return t
        t = t.repeat_interleave(self.config.n_heads // t.shape[2], dim=2)
        return t.chunk(self.tp.size, 2)[self.tp.index]

    def targets(self, tokens):
        if self.sp.size == 1:
            return super().targets(tokens)
        # the last position's target is the first token of the next chunk
        firsts = C.gather_values(tokens[:, :1].contiguous(), 1, self.sp)
        nxt = firsts[:, (self.sp.index + 1) % self.sp.size]
        return torch.cat([tokens[:, 1:], nxt[:, None]], 1).long()

    def nll(self, logits, targets):
        """Over the vocabulary's tp shards: the max and the sum of exps are
        reduced over tp (two numbers a token) instead of gathering the
        logits (a vocabulary's worth a token)."""
        if self.tp.size == 1:
            return super().nll(logits, targets)
        m = C.all_reduce_max(logits.detach().amax(-1, keepdim=True), self.tp)
        z = logits - m
        sumexp = C.sum_partials(z.exp().sum(-1), self.tp)
        v = logits.shape[-1]
        local = targets - self.tp.index * v
        here = (local >= 0) & (local < v)
        picked = torch.gather(z, -1, local.clamp(0, v - 1)[..., None])[..., 0]
        picked = C.sum_partials(torch.where(here, picked, 0.0), self.tp)
        return torch.log(sumexp) - picked

    def global_shape(self, b, s):
        return b * self.batch.size, s * self.sp.size

    def tokens(self, tokens):
        """This rank's piece of the step's tokens [B, S] (`batch_spec`)."""
        return shard(tokens, batch_spec(self.sp.size > 1), self.mesh)

    def reduce_grads(self, params: dict) -> None:
        """Sum each leaf's gradient over `grad_axes` of its spec, in place."""
        def reduce(t, spec):
            axes = grad_axes(spec)
            if t.grad is not None and self.mesh.size(axes) > 1:
                t.grad = C.sum_partials(t.grad, self.mesh.axis(axes))
            return t
        _map_params(reduce, params, self.specs)

    def data_sum(self, t):
        """A sum over every rank that holds other tokens (no gradient)."""
        return C.sum_partials(t.detach(), self.mesh.axis(DATA_AXES))
