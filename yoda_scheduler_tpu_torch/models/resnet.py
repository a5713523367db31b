"""ResNet-50 in PyTorch: the port of yoda_scheduler_tpu/models/resnet.py (a
ResNet-50 training pod, the JAX package's BASELINE scenario 3).

The batch is NHWC as in the JAX package; inside, the model runs the NCHW
view of it, which is `channels_last` in memory. The JAX model's numerics
are kept:

- every convolution pads "SAME" (Flax's default), which is asymmetric on
  even inputs: (2, 3) for the 7x7 stride-2 stem, (0, 1) for a 3x3 stride-2
  conv and for the 3x3 stride-2 max pool (padded with -inf);
- conv weights are stored in fp32 and cast to the compute dtype at use;
  conv outputs are in that dtype;
- BatchNorm computes in fp32 and outputs fp32; its batch variance is
  Flax's E[x^2] - E[x]^2 clipped at 0, and the running statistics take it
  biased: running = m running + (1 - m) batch, with m 0.9 in the blocks
  and Flax's default 0.99 at the stem (torch's momentum 0.1 and 0.01);
- the last BatchNorm of each block starts with a zero scale;
- the residual sum, block outputs, max pool, spatial mean and the Dense
  layer are fp32, so the logits are fp32.

A BatchNorm (with the ReLU that follows it) keeps only its input for the
backward and recomputes itself there, inside a `batch_norm` profiler span
(profile_path.py groups the device time under it).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from .._device import resolve_device

BLOCK_MOMENTUM = 0.9   # Flax's convention: the weight of the running value
STEM_MOMENTUM = 0.99   # the stem's BatchNorm sets none: Flax's default
BN_EPS = 1e-5
BN_SPAN = "batch_norm"


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of one spatial dimension under "SAME": the output
    is ceil(size / stride) long, the odd element of the padding goes high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad(x, kernel: int, stride: int, value: float = 0.0):
    """x [N, C, H, W] padded "SAME" for a square window; -> (x, symmetric
    padding left for the op to apply)."""
    (ht, hb), (wl, wr) = (same_pads(n, kernel, stride) for n in x.shape[2:])
    if ht == hb and wl == wr:
        return x, (ht, wl)
    return F.pad(x, (wl, wr, ht, hb), value=value), (0, 0)


def _batch_norm(x, scale, bias, mean, var, relu: bool):
    """Flax's BatchNorm in fp32 (statistics of x where mean is None), then
    the ReLU if asked: -> (y, mean, var)."""
    x32 = x.float()
    if mean is None:
        mean = x32.mean((0, 2, 3))
        var = ((x32 * x32).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
    y = (x32 - mean[:, None, None]) * (torch.rsqrt(var + BN_EPS) * scale)[:, None, None]
    y = y + bias[:, None, None]
    return (y.relu() if relu else y), mean, var


class _BatchNorm(torch.autograd.Function):
    """`_batch_norm` that saves only its inputs and recomputes itself in the
    backward (the same operations, so the same gradient as autograd's)."""

    @staticmethod
    def forward(ctx, x, scale, bias, mean, var, relu):
        with record_function(BN_SPAN):
            ctx.relu, ctx.batch = relu, mean is None
            ctx.save_for_backward(x, scale, bias, mean, var)
            y, mean, var = _batch_norm(x, scale, bias, mean, var, relu)
            ctx.mark_non_differentiable(mean, var)
            return y, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        x, scale, bias, mean, var = ctx.saved_tensors
        if ctx.batch:
            mean = var = None
        with record_function(BN_SPAN), torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip((x, scale, bias), ctx.needs_input_grad)]
            y = _batch_norm(*inputs, mean, var, ctx.relu)[0]
            wanted = [t for t in inputs if t.requires_grad]
            got = iter(torch.autograd.grad(y, wanted, g))
        return (*(next(got) if t.requires_grad else None for t in inputs),
                None, None, None)


class BatchNorm(nn.Module):
    """Flax's nn.BatchNorm(dtype=float32, epsilon=1e-5) over the channels of
    [N, C, H, W]; `momentum` in Flax's convention (the running value's
    weight). Train mode normalises by the batch's statistics and updates the
    running ones in place; eval mode normalises by the running ones."""

    def __init__(self, features: int, momentum: float, zero_scale: bool = False,
                 device=None):
        super().__init__()
        self.momentum, self.zero_scale = momentum, zero_scale
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("mean", torch.empty(features, device=device))
        self.register_buffer("var", torch.empty(features, device=device))

    def reset_parameters(self) -> None:
        nn.init.constant_(self.scale, 0.0 if self.zero_scale else 1.0)
        nn.init.zeros_(self.bias)
        nn.init.zeros_(self.mean)
        nn.init.ones_(self.var)

    def forward(self, x, train: bool = True, relu: bool = False):
        if not train:
            return _BatchNorm.apply(x, self.scale, self.bias, self.mean, self.var, relu)[0]
        y, mean, var = _BatchNorm.apply(x, self.scale, self.bias, None, None, relu)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return y


class Conv(nn.Module):
    """Flax's nn.Conv(use_bias=False) with "SAME" padding: an fp32 weight
    [out, in, k, k] cast to `dtype` at use, as is the input."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _lecun_normal(self.weight, self.weight[0].numel(), generator)

    def forward(self, x):
        x, padding = _pad(x.to(self.dtype), self.weight.shape[-1], self.stride)
        w = self.weight.to(self.dtype, memory_format=torch.channels_last)
        return F.conv2d(x, w, stride=self.stride, padding=padding)


class Dense(nn.Module):
    """Flax's nn.Dense(dtype=float32): fp32 weight [out, in] and bias."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, device=device))
        self.bias = nn.Parameter(torch.empty(cout, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _lecun_normal(self.weight, self.weight.shape[1], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


def _lecun_normal(t, fan_in: int, generator: torch.Generator) -> None:
    """Flax's default kernel init: a normal truncated at two deviations,
    scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, strides: int = 1,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        conv = lambda i, o, k, s=1: Conv(i, o, k, s, dtype, device)  # noqa: E731
        bn = lambda zero=False: BatchNorm(o4 if zero else features,  # noqa: E731
                                          BLOCK_MOMENTUM, zero, device)
        o4 = features * 4
        self.conv1, self.bn1 = conv(cin, features, 1), bn()
        self.conv2, self.bn2 = conv(features, features, 3, strides), bn()
        self.conv3, self.bn3 = conv(features, o4, 1), bn(zero=True)
        # the JAX block projects the residual where its shape differs from
        # the output's: always where the channels differ
        self.proj_conv = self.proj_bn = None
        if cin != o4:
            self.proj_conv = conv(cin, o4, 1, strides)
            self.proj_bn = BatchNorm(o4, BLOCK_MOMENTUM, device=device)

    def forward(self, x, train: bool = True):
        y = self.bn1(self.conv1(x), train, relu=True)
        y = self.bn2(self.conv2(y), train, relu=True)
        y = self.bn3(self.conv3(y), train)
        residual = x if self.proj_conv is None else self.proj_bn(self.proj_conv(x), train)
        return (y + residual).relu()


class ResNet(nn.Module):
    """ResNet with bottleneck blocks over RGB images; forward(x [B, H, W,
    3], train) -> fp32 logits [B, num_classes]. Weights made on `device`
    with Flax's initialisers (`reset_parameters(seed)`, seed 0 here)."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.conv = Conv(3, 64, 7, 2, dtype, dev)
        self.bn = BatchNorm(64, STEM_MOMENTUM, device=dev)
        blocks, cin = [], 64
        for i, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                strides = 2 if i > 0 and j == 0 else 1
                blocks.append(Bottleneck(cin, 64 * 2 ** i, strides, dtype, dev))
                cin = 64 * 2 ** i * 4
        self.blocks = nn.ModuleList(blocks)
        self.fc = Dense(cin, num_classes, device=dev)
        self.reset_parameters(0)

    def reset_parameters(self, seed: int = 0) -> None:
        gen = torch.Generator(device=self.fc.weight.device).manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (Conv, Dense)):
                m.reset_parameters(gen)
            elif isinstance(m, BatchNorm):
                m.reset_parameters()

    def forward(self, x, train: bool = True):
        x = x.permute(0, 3, 1, 2)  # NHWC -> the NCHW view, channels_last
        x = self.bn(self.conv(x), train, relu=True)
        x, _ = _pad(x, 3, 2, value=-math.inf)
        x = F.max_pool2d(x, 3, 2)
        for block in self.blocks:
            x = block(x, train)
        return self.fc(x.mean((2, 3)))


def ResNet50(num_classes: int = 1000, dtype=torch.bfloat16, device="cuda") -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), num_classes=num_classes, dtype=dtype,
                  device=device)


def resnet_forward_fn(num_classes: int = 1000, device="cuda", model: ResNet | None = None):
    """(init_fn, apply_fn) pair for the training harness, the JAX package's
    functional interface over one module:

    - init_fn(seed, sample) -> variables {"params": {name: tensor},
      "batch_stats": {name: tensor}}, fresh weights from `seed`
    - apply_fn(variables, batch, train=True) -> (logits, {"batch_stats":
      updated}) in train mode (`variables` are left as they are), logits in
      eval mode; `batch` is NHWC

    `model` (another depth or dtype) replaces ResNet50(num_classes, device=
    device)."""
    model = model if model is not None else ResNet50(num_classes, device=device)

    def init_fn(seed: int, sample):
        if sample.shape[-1] != model.conv.weight.shape[1]:
            raise ValueError(f"sample has {sample.shape[-1]} channels, the model "
                             f"takes {model.conv.weight.shape[1]}")
        model.reset_parameters(seed)
        return {"params": {n: p.detach().clone() for n, p in model.named_parameters()},
                "batch_stats": {n: b.clone() for n, b in model.named_buffers()}}

    def apply_fn(variables: dict, batch, train: bool = True):
        stats = variables["batch_stats"]
        if train:
            stats = {n: t.clone() for n, t in stats.items()}
        logits = torch.func.functional_call(model, {**variables["params"], **stats},
                                            (batch,), {"train": train})
        return (logits, {"batch_stats": stats}) if train else logits

    return init_fn, apply_fn
