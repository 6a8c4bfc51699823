"""ResNet family — the port of ``mmlspark_tpu/models/resnet.py``.

Flagship inference model: ResNet-20 for CIFAR-10, the model the
reference's north-star notebook evaluates (notebook 301). ResNet-50 is the
transfer-learning featurizer (notebooks 303/305); cut at ``pool`` for
2048-d features.

The arithmetic is flax's, step for step:

- the network runs NHWC, as flax does and the Dataset holds images.
  Each convolution views its input as NCHW — a permute of a contiguous
  NHWC tensor has ``channels_last`` strides, so no copy is made — and
  hands its output back as NHWC the same way; on the card the
  convolutions are cuDNN's in ``channels_last``. Everything else
  (BatchNorm, the residual add, ReLU, the casts) runs on contiguous NHWC
  tensors with the channel last, so PyTorch's elementwise kernels read
  them vectorized;
- a convolution (:class:`Conv`, flax ``nn.Conv(use_bias=False,
  padding="SAME", dtype=bfloat16, param_dtype=float32)``) casts its input
  and its f32 OIHW weight to bf16 per call, and returns bf16. SAME
  padding follows XLA's rule, ``total = max((ceil(n/s) - 1)·s + k - n,
  0)`` with ``low = total // 2``: asymmetric for a stride-2 layer on an
  even size (a 3x3 stride-2 convolution on 32 pads 0 before and 1 after),
  so it is padded explicitly there;
- :class:`BatchNorm` (flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5,
  dtype=float32)``) computes in f32, so its output is f32; in train mode
  it normalises with the batch's mean and its BIASED variance,
  ``E[x²] - E[x]²`` clamped at 0 (flax's ``use_fast_variance``), and
  leaves the new running statistics ``0.9·running + 0.1·batch`` in its
  ``new_stats`` for the graph to collect;
- the residual add and the ReLU run on BatchNorm's f32 output;
- the SAME 3x3 stride-2 max pool of ResNet-50's stem pads with -inf;
- :class:`Logits` is a bf16 Dense returned in f32.

Submodules carry flax's auto-names (``ConvBN_0``, ``Conv_0``,
``BatchNorm_0``, ``ResBlock_0``, ``BottleneckBlock_0``, ``Dense_0``), so
the weight bridge finds each flax leaf at the port parameter's path:
``stage2/ResBlock_0/ConvBN_2`` is the projection shortcut.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.models.graph import FINAL_NODE, NamedGraph
from mmlspark_tpu_torch.models.registry import register_model
from mmlspark_tpu_torch.models.transformer import Dense

Pair = tuple[int, int]


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """(before, after) SAME padding of one spatial dim of size ``n`` for a
    window ``k`` at stride ``s``, by XLA's rule."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _nhwc_pads(x, kernel: Pair, strides: Pair) -> tuple[int, ...]:
    """``F.pad``'s amounts for an NHWC ``x``: (0, 0) on the channels,
    then (left, right) and (top, bottom)."""
    top, bottom = same_pads(x.shape[1], kernel[0], strides[0])
    left, right = same_pads(x.shape[2], kernel[1], strides[1])
    return 0, 0, left, right, top, bottom


def same_max_pool(x):
    """flax ``nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")`` on
    an NHWC ``x``: the SAME padding is -inf."""
    x = F.pad(x, _nhwc_pads(x, (3, 3), (2, 2)), value=float("-inf"))
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False, padding="SAME")``: an f32 OIHW
    ``weight``, computed in the caller's dtype; NHWC in and out."""

    def __init__(self, in_features: int, features: int, kernel: Pair,
                 strides: Pair):
        super().__init__()
        self.kernel = tuple(kernel)
        self.strides = tuple(strides)
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               *self.kernel))

    def forward(self, x, dtype):
        w = self.weight.to(dtype, memory_format=torch.channels_last)
        x = x.to(dtype)
        pads = _nhwc_pads(x, self.kernel, self.strides)
        _, _, left, right, top, bottom = pads
        if left == right and top == bottom:
            padding = (top, left)
        else:
            x, padding = F.pad(x, pads), (0, 0)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=self.strides,
                     padding=padding)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels (the last axis) of an NHWC
    input, in f32: parameters ``weight`` (flax's ``scale``) and
    ``bias``, statistics ``mean`` and ``var`` (buffers: flax's
    ``batch_stats``)."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mean", torch.empty(features))
        self.register_buffer("var", torch.empty(features))
        self.new_stats = None

    def forward(self, x, train: bool = False):
        if train:
            x = x.float()
            mean, var = _batch_moments(x)
            m = self.momentum
            self.new_stats = {
                "mean": (m * self.mean + (1 - m) * mean).detach(),
                "var": (m * self.var + (1 - m) * var).detach(),
            }
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.weight
        # a bf16 x minus the f32 mean is computed in f32 (exact promotion)
        return (x - mean) * mul + self.bias


def _batch_moments(x):
    """The per-channel mean and variance of an NHWC batch; inside the mesh
    trainer's step (``parallel/mesh.local_batch``) over every data rank's
    rows, as the JAX package's BatchNorm sees the sharded global batch."""
    from mmlspark_tpu_torch.parallel.mesh import AllReduce, batch_stats_axis

    axis = batch_stats_axis()
    if axis is None:
        mean = x.mean(dim=(0, 1, 2))
        return mean, torch.clamp((x * x).mean(dim=(0, 1, 2)) - mean * mean,
                                 min=0.0)
    c = x.shape[-1]
    n = torch.full((1,), x.shape[0] * x.shape[1] * x.shape[2],
                   dtype=x.dtype, device=x.device)
    sums = AllReduce.apply(torch.cat([x.sum(dim=(0, 1, 2)),
                                      (x * x).sum(dim=(0, 1, 2)), n]), axis)
    mean = sums[:c] / sums[-1]
    return mean, torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)


class ConvBN(nn.Module):
    """Conv + BatchNorm + optional ReLU, NHWC; the convolution computes in
    ``dtype`` (flax's ``dtype`` field: bf16 unless a caller sets f32)."""

    def __init__(self, in_features: int, features: int,
                 kernel: Pair = (3, 3), strides: Pair = (1, 1),
                 use_relu: bool = True):
        super().__init__()
        self.use_relu = use_relu
        self.dtype = torch.bfloat16
        self.Conv_0 = Conv(in_features, features, kernel, strides)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x, train: bool = False):
        x = self.BatchNorm_0(self.Conv_0(x, self.dtype), train)
        return F.relu(x) if self.use_relu else x


class ResBlock(nn.Module):
    """Basic (2-conv) residual block; ``ConvBN_2`` projects the shortcut
    where the shape changes."""

    def __init__(self, in_features: int, features: int,
                 strides: Pair = (1, 1)):
        super().__init__()
        self.ConvBN_0 = ConvBN(in_features, features, strides=strides)
        self.ConvBN_1 = ConvBN(features, features, use_relu=False)
        if in_features != features or tuple(strides) != (1, 1):
            self.ConvBN_2 = ConvBN(in_features, features, (1, 1), strides,
                                   use_relu=False)

    def forward(self, x, train: bool = False):
        y = self.ConvBN_1(self.ConvBN_0(x, train), train)
        if hasattr(self, "ConvBN_2"):
            x = self.ConvBN_2(x, train)
        return F.relu(y + x)


class BottleneckBlock(nn.Module):
    """1-3-1 bottleneck block (ResNet-50 style); the output is
    ``4 * features`` wide and ``ConvBN_3`` projects the shortcut."""

    def __init__(self, in_features: int, features: int,
                 strides: Pair = (1, 1)):
        super().__init__()
        out = features * 4
        self.ConvBN_0 = ConvBN(in_features, features, (1, 1))
        self.ConvBN_1 = ConvBN(features, features, strides=strides)
        self.ConvBN_2 = ConvBN(features, out, (1, 1), use_relu=False)
        if in_features != out or tuple(strides) != (1, 1):
            self.ConvBN_3 = ConvBN(in_features, out, (1, 1), strides,
                                   use_relu=False)

    def forward(self, x, train: bool = False):
        y = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x, train), train),
                          train)
        if hasattr(self, "ConvBN_3"):
            x = self.ConvBN_3(x, train)
        return F.relu(y + x)


class Stage(nn.Module):
    """A stack of residual blocks at one resolution."""

    def __init__(self, block: type, in_features: int, features: int,
                 count: int, first_strides: Pair):
        super().__init__()
        self.names = [f"{block.__name__}_{i}" for i in range(count)]
        width = features * (4 if block is BottleneckBlock else 1)
        for i, name in enumerate(self.names):
            setattr(self, name, block(in_features if i == 0 else width,
                                      features,
                                      first_strides if i == 0 else (1, 1)))

    def forward(self, x, train: bool = False):
        for name in self.names:
            x = getattr(self, name)(x, train)
        return x


class GlobalPool(nn.Module):
    """Mean over H and W of an NHWC input."""

    def forward(self, x):
        return x.mean(dim=(1, 2))


class Logits(nn.Module):
    """A Dense computed in ``dtype`` (bf16), returned in f32."""

    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        self.dtype = torch.bfloat16
        self.Dense_0 = Dense(in_features, num_classes)

    def forward(self, x):
        return self.Dense_0(x, self.dtype).float()


class Stem(nn.Module):
    """The first ConvBN, and ResNet-50's SAME 3x3 stride-2 max pool."""

    def __init__(self, features: int, kernel: Pair, strides: Pair,
                 max_pool: bool, in_features: int = 3):
        super().__init__()
        self.max_pool = max_pool
        self.ConvBN_0 = ConvBN(in_features, features, kernel, strides)

    def forward(self, x, train: bool = False):
        x = self.ConvBN_0(x, train)
        if self.max_pool:
            x = same_max_pool(x)
        return x


@register_model("resnet20_cifar10")
def resnet20_cifar10(num_classes: int = 10, width: int = 16) -> NamedGraph:
    """ResNet-20 (3 stages x 3 basic blocks) for 32x32 inputs — the
    CIFAR-10 eval model of reference notebook 301."""
    with torch.device("meta"):
        blocks: list[tuple[str, nn.Module]] = [
            ("stem", Stem(width, (3, 3), (1, 1), max_pool=False)),
            ("stage1", Stage(ResBlock, width, width, 3, (1, 1))),
            ("stage2", Stage(ResBlock, width, width * 2, 3, (2, 2))),
            ("stage3", Stage(ResBlock, width * 2, width * 4, 3, (2, 2))),
            ("pool", GlobalPool()),
            (FINAL_NODE, Logits(width * 4, num_classes)),
        ]
    return NamedGraph(name="resnet20_cifar10", blocks=blocks,
                      input_shape=(32, 32, 3), compute_dtype=torch.bfloat16)


@register_model("resnet50")
def resnet50(num_classes: int = 1000, input_size: int = 224) -> NamedGraph:
    """ResNet-50 (bottleneck 3-4-6-3) — the transfer-learning featurizer of
    reference notebooks 303/305; cut at 'pool' for 2048-d features."""
    with torch.device("meta"):
        blocks: list[tuple[str, nn.Module]] = [
            ("stem", Stem(64, (7, 7), (2, 2), max_pool=True)),
            ("stage1", Stage(BottleneckBlock, 64, 64, 3, (1, 1))),
            ("stage2", Stage(BottleneckBlock, 256, 128, 4, (2, 2))),
            ("stage3", Stage(BottleneckBlock, 512, 256, 6, (2, 2))),
            ("stage4", Stage(BottleneckBlock, 1024, 512, 3, (2, 2))),
            ("pool", GlobalPool()),
            (FINAL_NODE, Logits(2048, num_classes)),
        ]
    return NamedGraph(name="resnet50", blocks=blocks,
                      input_shape=(input_size, input_size, 3),
                      compute_dtype=torch.bfloat16)
