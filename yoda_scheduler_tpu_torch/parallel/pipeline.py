"""Pipeline parallelism over the pp mesh axis: GPipe microbatching of the
Llama layer stack.

The port of yoda_scheduler_tpu/parallel/pipeline.py. Stage i of pp holds
the contiguous block of layers [i L/pp, (i + 1) L/pp) (the pipeline's specs
split the list of layers over pp); the embedding, the final norm and the lm
head are on every stage, as the JAX package replicates them over pp. M
microbatches go through the P stages in M + P - 1 ticks: at tick t stage s
runs microbatch t - s, stage 0 injecting it and the last stage retiring it.
The JAX package computes the bubble ticks and masks them; here they are
skipped, which is exact (no launch, no aux). Each stage's block runs through
the model's plan hooks (parallel/sharding.py:ShardPlan), so tp, fsdp and ep
work inside a stage as on the step without pp.

The whole schedule is one autograd Function (`_Pipeline`): its forward runs
the ticks, building each (stage, microbatch)'s graph from a detached input;
its backward runs the ticks in reverse, each stage receiving its output's
gradient from the next stage, differentiating its block and sending its
input's gradient back. Every process runs every hand-over of both
directions in one fixed order, whatever it uses of the result, so no peer
waits on a hand-over that autograd would skip.

Two spellings of the hand-over, one tick loop and one stage body:

- on a mesh, one process per rank: its own stage, the tensors sent to the
  neighbouring stages over the pp group (point-to-point);
- `pp=` without a mesh: one process runs every stage's block (the card is
  one, and NCCL takes one rank per GPU), handing the tensors on in place.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..models.llama import (ONE_DEVICE, LlamaConfig, ce_share, final_logits, init_llama,
                            run_layers)
from . import collectives as C
from .sharding import ShardPlan, llama_param_specs, shard, shard_params
from .train import init_opt_state


def llama_pipeline_param_specs(config: LlamaConfig | None = None) -> dict:
    """llama_param_specs with the list of layers split over pp: each stage
    holds only its own block of layers."""
    return {**llama_param_specs(config), "layer_list": "pp"}


def _check(config: LlamaConfig, pp: int, sp: int, batch: int | None = None,
           microbatches: int | None = None) -> None:
    """The JAX package's refusals, in its order and words."""
    if config.n_layers % pp:
        raise ValueError(
            f"n_layers={config.n_layers} not divisible by pp={pp}")
    if batch is not None and batch % microbatches:
        raise ValueError(f"batch {batch} not divisible by {microbatches} microbatches")
    if sp > 1:
        raise ValueError("pipeline step runs with sp=1 (ring attention's own "
                         "shard_map does not nest inside the pp region)")
    if config.sliding_window is not None:
        raise ValueError(
            "sliding_window is not supported on the pipeline path yet")


def _stage_blocks(layers: list, pp: int) -> dict:
    """{stage: its block of layers} of every stage, from the whole list."""
    n = len(layers) // pp
    return {s: layers[s * n:(s + 1) * n] for s in range(pp)}


class _Local:
    """Hands tensors between stages that run in this process."""

    def __init__(self):
        self.slots = {}

    def send(self, t, to: int, m: int) -> None:
        self.slots[to, m] = t

    def recv(self, at: int, frm: int, m: int, like):
        return self.slots.pop((at, m))


class _PointToPoint:
    """Hands tensors between stages on other ranks of the pp axis (stage s is
    the axis's index s); each send waits for its receive."""

    def __init__(self, axis):
        self.axis = axis

    def _wait(self, op, t, stage: int) -> None:
        p2p = dist.P2POp(op, t, self.axis.ranks[stage], self.axis.group)
        for work in dist.batch_isend_irecv([p2p]):
            work.wait()

    def send(self, t, to: int, m: int) -> None:
        self._wait(dist.isend, t.contiguous(), to)

    def recv(self, at: int, frm: int, m: int, like):
        t = torch.empty(like[0], dtype=like[1], device=like[2])
        self._wait(dist.irecv, t, frm)
        return t


class _Schedule:
    """GPipe as this process runs it: M microbatches through P stages in
    M + P - 1 ticks. `blocks` {stage: layers} are the stages this process
    runs, `body(layers, x) -> (y, aux)` one stage's block, `link` the
    hand-over, `act` (shape, dtype, device) of a microbatch's activations."""

    def __init__(self, blocks: dict, pp: int, microbatches: int, body, link, act):
        self.blocks, self.pp, self.m, self.body = blocks, pp, microbatches, body
        self.link, self.act = link, act
        self.keys = [(s, i, n) for s, block in blocks.items()
                     for i, layer in enumerate(block) for n in layer]

    def ticks(self) -> list:
        """(stage, microbatch) in the order this process runs them: tick by
        tick, the bubble (stage s before tick s or after tick s + M - 1)
        skipped."""
        return [(s, t - s) for t in range(self.m + self.pp - 1)
                for s in self.blocks if 0 <= t - s < self.m]

    def leaves(self) -> list:
        return [self.blocks[s][i][n] for s, i, n in self.keys]

    def rebuild(self, leaves: list) -> dict:
        blocks = {s: [{} for _ in block] for s, block in self.blocks.items()}
        for (s, i, n), t in zip(self.keys, leaves):
            blocks[s][i][n] = t
        return blocks


class _Pipeline(torch.autograd.Function):
    """(schedule, x_mb, *layer leaves) -> (y_mb, aux): x_mb [M, mb, S, d] the
    embedded microbatches (None where this process runs no stage 0), y_mb
    the last stage's outputs in microbatch order (empty where this process
    runs no last stage), aux the sum of this process's stages' MoE aux over
    its layers and microbatches. The gradients of the layer leaves are
    returned by the backward, summed over the microbatches."""

    @staticmethod
    def forward(ctx, sched, x_mb, *leaves):
        grad = any(ctx.needs_input_grad)
        aliases = [t.detach().requires_grad_(t.requires_grad) for t in leaves]
        blocks = sched.rebuild(aliases)
        last = sched.pp - 1
        saved, ys = {}, {}
        aux = torch.zeros((), dtype=torch.float32, device=sched.act[2])
        with torch.set_grad_enabled(grad):
            for s, m in sched.ticks():
                x = x_mb[m] if s == 0 else sched.link.recv(s, s - 1, m, sched.act)
                x = x.detach().requires_grad_(grad)
                y, a = sched.body(blocks[s], x)
                if grad:
                    saved[s, m] = (x, y, a)
                if torch.is_tensor(a):
                    aux = aux + a.detach()
                if s == last:
                    ys[m] = y.detach()
                else:
                    sched.link.send(y.detach(), s + 1, m)
        ctx.sched, ctx.aliases, ctx.saved = sched, aliases, saved
        y_mb = (torch.stack([ys[m] for m in range(sched.m)]) if ys
                else torch.empty(0, device=sched.act[2]))
        return y_mb, aux

    @staticmethod
    def backward(ctx, g_y, g_aux):
        sched, saved = ctx.sched, ctx.saved
        last = sched.pp - 1
        g_x = {}
        for s, m in reversed(sched.ticks()):
            x, y, a = saved.pop((s, m))
            g = g_y[m] if s == last else sched.link.recv(s, s + 1, m,
                                                         (y.shape, y.dtype, y.device))
            roots, grads = [y], [g]
            if torch.is_tensor(a) and a.requires_grad:
                roots.append(a)
                grads.append(g_aux)
            torch.autograd.backward(roots, grads)
            del y, a, roots, grads
            if s == 0:
                g_x[m] = x.grad
            else:
                sched.link.send(x.grad, s - 1, m)
        grads = [t.grad for t in ctx.aliases]
        ctx.sched = ctx.aliases = ctx.saved = None
        dx = torch.stack([g_x[m] for m in range(sched.m)]) if g_x else None
        return (None, dx, *grads)


def _pipeline(sched, x_mb):
    return _Pipeline.apply(sched, x_mb, *sched.leaves())


def _microbatches(pp: int, num_microbatches: int | None) -> int:
    return num_microbatches or max(2 * pp, 2)


def _terms(params: dict, tokens, config: LlamaConfig, mesh, pp: int | None,
           num_microbatches: int | None, remat: bool):
    """-> (objective, loss): this process's part of the pipelined loss to
    differentiate, and the step's loss (no gradient), the same on every
    rank."""
    if mesh is None:
        plan, pp_axis, sp, link = ONE_DEVICE, None, 1, _Local()
    else:
        plan, pp_axis = ShardPlan(config, mesh), mesh.axis("pp")
        pp, sp = pp_axis.size, mesh.shape["sp"]
        link = _PointToPoint(pp_axis) if pp > 1 else _Local()
    M = _microbatches(pp, num_microbatches)
    b, s = tokens.shape
    _check(config, pp, sp, plan.global_shape(b, s)[0], M)
    if b % M:
        raise ValueError(f"this rank's {b} rows do not split into {M} microbatches")
    blocks = (_stage_blocks(params["layers"], pp) if mesh is None
              else {pp_axis.index: params["layers"]})
    d = config.dim
    # every stage holds the embedding: its dtype is the activations'
    act = ((b // M, s, d), params["embed"].dtype, tokens.device)
    table = plan.leaf("embed", params["embed"]) if 0 in blocks else None
    attn_impl, moe_part = plan.attention(config), plan.moe_part

    def body(layers, x):
        return run_layers(layers, x, config, attn_impl, remat, moe_part, plan)

    sched = _Schedule(blocks, pp, M, body, link, act)
    x_mb = table[tokens.view(M, b // M, s)] if table is not None else None
    y_mb, aux = _pipeline(sched, x_mb)
    aux_term = config.moe_aux_weight * aux / (config.n_layers * M)
    if pp - 1 in blocks:
        ce = ce_share(final_logits(params, y_mb.reshape(b, s, d), config, plan), tokens,
                      plan)
        objective = ce + aux_term
        loss = (ce.detach() if mesh is None else plan.data_sum(ce)) + aux_term.detach()
    else:
        objective, loss = aux_term, aux_term.detach()
    if pp_axis is not None:
        loss = C.sum_partials(loss, pp_axis)
    return objective, loss


def pipelined_llama_loss(params: dict, tokens, config: LlamaConfig, mesh=None,
                         num_microbatches: int | None = None, remat: bool = True,
                         pp: int | None = None):
    """Next-token cross-entropy plus the MoE aux term with the layer stack
    pipelined over pp: the same math as models.llama.llama_loss, with the aux
    summed over layers and microbatches and divided by L M (each
    microbatch's load-balance statistic is over its own tokens).
    Microbatch m is the step's rows [m B/M, (m + 1) B/M); M defaults to
    max(2 pp, 2).

    - On a mesh: this rank's stage, `tokens` as the step's `batch_fn` gives
      them (each microbatch's rows split over dp, fsdp and ep, microbatch by
      microbatch) and `params` as `shard_params` with the pipeline's specs
      gives them; -> this rank's part: the step's loss is the sum of the
      last stage's cross-entropy parts over the ranks that split the rows,
      plus the weighted aux of every stage once. Differentiate it with
      `.backward()` on every rank of the mesh.
    - With mesh None and `pp` stages: every stage in this process, the whole
      `tokens` [B, S] and `params`; -> the loss."""
    if (mesh is None) == (pp is None):
        raise ValueError("pass a mesh, or pp without a mesh")
    return _terms(params, tokens, config, mesh, pp, num_microbatches, remat)[0]


def _reduce_grads(plan, params: dict, pp_axis) -> None:
    """The embedding is used on stage 0 and the final norm and lm head on
    the last stage: every stage's copy takes the sum over pp of their
    gradients (zeros where a stage did not use them), so that every copy
    takes the same step. Then each leaf's sum over the data axes."""
    if pp_axis.size > 1:
        for n in ("embed", "final_norm", "lm_head"):
            t = params[n]
            t.grad = C.sum_partials(t.grad if t.grad is not None else torch.zeros_like(t),
                                    pp_axis)
    plan.reduce_grads(params)


def build_pipelined_llama_train_step(config: LlamaConfig, mesh=None,
                                     num_microbatches: int | None = None,
                                     learning_rate: float = 3e-4, remat: bool = True,
                                     device="cuda", pp: int | None = None):
    """The pipelined twin of train.build_llama_train_step: -> (init_fn,
    step_fn, batch_fn), the parameters staged over pp.

    - init_fn(seed) -> (params, opt_state): this rank's shards of the
      `init_llama(seed)` weights under `llama_pipeline_param_specs` (its
      stage's layers), requiring grad, and AdamW over them
    - step_fn(params, opt_state, tokens) -> (params, opt_state, loss):
      `tokens` as batch_fn gives them; the pipelined loss and its gradient,
      the replicated leaves' gradients summed over pp and every leaf's over
      the ranks that hold other rows, then AdamW in place; the step's loss
      as a 0-d tensor, the same on every rank
    - batch_fn(tokens) -> this rank's rows of the step's tokens [B, S], for
      each microbatch its split over dp, fsdp and ep, microbatch-major

    With mesh None, `pp` stages run in this process on `device` (whole
    parameters, the whole batch); with a mesh the device is the mesh's."""
    if (mesh is None) == (pp is None):
        raise ValueError("pass a mesh, or pp without a mesh")
    if mesh is None:
        dev, sp = resolve_device(device), 1
    else:
        dev, pp, sp = mesh.device, mesh.shape["pp"], mesh.shape["sp"]
    _check(config, pp, sp)
    M = _microbatches(pp, num_microbatches)
    specs = llama_pipeline_param_specs(config)
    plan = None if mesh is None else ShardPlan(config, mesh)

    def init_fn(seed: int = 0):
        params = init_llama(config, seed=seed, device=dev)
        if mesh is not None:
            params = shard_params(params, mesh, config, specs)
        return params, init_opt_state(params, learning_rate)

    def step_fn(params: dict, opt_state, tokens):
        objective, loss = _terms(params, tokens.to(dev), config, mesh, pp, M, remat)
        objective.backward()
        if plan is not None:
            _reduce_grads(plan, params, mesh.axis("pp"))
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return params, opt_state, loss

    def batch_fn(tokens):
        tokens = tokens.to(dev)
        b, s = tokens.shape
        if b % M:
            raise ValueError(f"batch {b} not divisible by {M} microbatches")
        if mesh is None:
            return tokens
        rows = shard(tokens.view(M, b // M, s), (None, ("dp", "fsdp", "ep"), None), mesh)
        return rows.reshape(-1, s)

    return init_fn, step_fn, batch_fn
