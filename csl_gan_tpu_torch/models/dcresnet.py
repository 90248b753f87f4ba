"""DCResNet WGAN pair (the JAX package's models/dcresnet.py) as nn.Modules.

Generator: linear stem -> upsampling residual blocks (nearest 2x upsample +
5x5 conv; norm + ReLU) -> norm + ReLU -> 3x3 conv -> tanh. The norm is
GroupNorm(32) when per-sample gradients are on (``-dpm gc / tm / sv``) and
BatchNorm otherwise (``-dpm is`` and non-private runs; ``bn``), as the JAX
package and the reference choose it (init_util.py: bn = not
per_sample_grad). Discriminator: strided 5x5 convs with leaky-relu(0.2),
flatten, then the heads by conditional arch: ACGAN, the linear critic
``linOut`` and the auxiliary classifier ``linOutAux``; CGAN, the one-hot
label as n_classes constant input planes and ``linOut``; WCGAN, the planes
and a per-class critic ``linOutAux`` whose label column is the critic's
output (no ``linOut``); unconditional, ``linOut`` alone. The G takes the
label as a one-hot concatenated to z (``concat``) or as z * Embed(y)
(``embed``, ``Embed_0`` initialised from N(0, 1)). family = "wgan".

Module names are the JAX package's (``Embed_0``, ``TorchDense_0``, ``ResBlockUp_i``,
``UpsampleConv_0/1``, ``GroupNorm_0/1`` or ``BatchNorm_0/1``, ``TorchConv_i``, ``linOut``,
``linOutAux``), so a state-dict key is the flax param path without its
``Conv_0`` level (convert.py). Activations are NHWC at every public function
and run as channels-last tensors inside.

``dtype`` is the compute dtype (``--bf16``): parameters stay fp32, convs take
bf16 inputs and weights and give bf16 outputs (flax nn.Conv), dense layers take
bf16-rounded inputs and weights with an fp32 product and output (TorchDense's
preferred_element_type), and tanh runs in fp32.

Under a model axis (``--tp``; the forwards' ``mesh``, a
``parallel.MeshContext`` of tp > 1 that the step builder passes) a layer
whose weight arrives as this rank's slice of output channels is
column-parallel: its input enters through ``mesh.copy_model``, a replicated
bias is sliced by ``mesh.split_model`` and the layer computes this rank's
channels only (``_conv``, ``_dense``). A consumer that needs every channel
gathers them (``_full``: the next layer's input, the flatten before the
heads, the dense stem before its reshape, tanh's input). A GroupNorm whose
32 groups and channels the tensor axis divides runs on the rank's channels
with 32 / tp groups (K4/K5 on [B, HW, C / tp]); one that it does not
divide, and BatchNorm (per channel, its statistics over the data group),
run on every channel. The residual sum adds the slices before one gather.
Without a mesh every layer is whole and the arithmetic is unchanged.

``ref_ps`` (``--ref_pixel_shuffle``, set for checkpoints converted from the
reference, training/ref_convert.py) swaps every upsample, the 1x1 shortcut's
included, for the reference's channel-scrambling pixel shuffle
(``common.ref_pixel_shuffle_upsample_2x``), ahead of the conv; the state dict
is the same.

Differences from the JAX modules, by design:
  - The upsample-then-5x5-conv is computed the plain way (upsample, then
    ``F.conv2d``). The JAX package's phase form (``_PhaseConv``,
    ``collapse_phase_kernel``, ``phase_d2s``) and its ``--phase_gn4`` /
    ``--phase_carry`` variants are TPU layout choices with identical values.
  - Every GroupNorm+ReLU is the K4/K5 autograd function of
    ops/pallas_groupnorm.py.
  - BatchNorm (``BatchNormRelu``) keeps its running averages as buffers
    (``mean``, ``var``: the flax ``batch_stats``); the G forward takes
    ``train``: batch statistics, with the running averages updated in place
    in the buffers it was given, or (eval) the running averages.
  - The D's ``embed`` label mode is refused, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from csl_gan_tpu_torch.models.common import (one_hot, ref_pixel_shuffle_upsample_2x,
                                             upsample_nearest_2x)
from csl_gan_tpu_torch.ops.pallas_groupnorm import group_norm_relu


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
              stride, padding, dtype=None) -> torch.Tensor:
    """flax nn.Conv on NHWC x (torch weight [O, I, kh, kw]) with the compute
    dtype: input, kernel and bias cast to it, output in it (fp32 when dtype
    is None)."""
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
        b = None if b is None else b.to(dtype)
    return F.conv2d(x.permute(0, 3, 1, 2), w, b, stride, padding).permute(0, 2, 3, 1)


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
          dtype=None) -> torch.Tensor:
    """TorchDense (torch weight [out, in]): with a compute dtype,
    bf16-rounded operands and an fp32 product (exact products, fp32
    accumulation), fp32 output; + fp32 bias."""
    if dtype is not None:
        x, w = x.to(dtype).float(), w.to(dtype).float()
    y = x @ w.T
    return y if b is None else y + b


def _full(t: torch.Tensor, channels: int, mesh) -> torch.Tensor:
    """NHWC (or [B, F]) ``t`` with every one of its ``channels`` on its
    last dim: the gather of this rank's slice under a model axis."""
    if mesh is None or t.shape[-1] == channels:
        return t
    return mesh.gather_model(t, -1)


def _local(t: torch.Tensor, channels: int, mesh) -> torch.Tensor:
    """This rank's slice of ``t``'s last dim, unless it is one already."""
    return t if t.shape[-1] != channels else mesh.split_model(t, -1)


def _col_bias(w: torch.Tensor, b: Optional[torch.Tensor], mesh):
    """The bias of a column-parallel layer: a replicated bias is sliced by
    ``split_model`` (its gradient then summed over the model group)."""
    if b is None or b.shape[0] == w.shape[0]:
        return b
    return mesh.split_model(b, 0)


def _conv(x, conv: nn.Conv2d, dtype, mesh=None):
    """The conv on every input channel; under a model axis its output is
    this rank's channels when its weight is this rank's slice."""
    w, b = conv.weight, conv.bias
    if mesh is not None:
        x = _full(x, conv.in_channels, mesh)
        if w.shape[0] != conv.out_channels:
            x, b = mesh.copy_model(x), _col_bias(w, b, mesh)
    return conv_nhwc(x, w, b, conv.stride, conv.padding, dtype)


def _dense(x, lin: nn.Linear, dtype, mesh=None):
    """``dense`` with every output feature (gathered under a model axis)."""
    w, b = lin.weight, lin.bias
    if mesh is None or w.shape[0] == lin.out_features:
        return dense(x, w, b, dtype)
    return _full(dense(mesh.copy_model(x), w, _col_bias(w, b, mesh), dtype),
                 lin.out_features, mesh)


def gn_relu(x: torch.Tensor, gn: nn.GroupNorm) -> torch.Tensor:
    return group_norm_relu(x, gn.weight, gn.bias, gn.num_groups, gn.eps)


class BatchNormRelu(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` + ReLU over NHWC, in
    fp32 (the JAX G's norm layers compute fp32 under --bf16). In training
    mode it normalizes by the batch's mean and fast variance
    max(E[x^2] - E[x]^2, 0) and writes 0.9 * running + 0.1 * batch into its
    ``mean`` / ``var`` buffers in place (outside autograd); in eval mode it
    normalizes by the buffers.

    Under a data axis (``mesh``, a ``parallel.MeshContext`` with a process
    group, set by the step builder) x is a rank's rows and the statistics
    are the global batch's, as the JAX package's sharded batch gives them:
    the sum and the sum of squares over the rank's rows, summed over the
    ranks by a differentiable sum whose backward sums the ranks' gradients
    (``sum_distinct``; ``nn.SyncBatchNorm`` refuses CPU tensors)."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.momentum, self.eps = momentum, eps
        self.mesh = None

    def _batch_stats(self, xf: torch.Tensor):
        if self.mesh is None or not self.mesh.grouped:
            mean = xf.mean(dim=(0, 1, 2))
            return mean, (xf * xf).mean(dim=(0, 1, 2))
        c = xf.shape[-1]
        count = torch.full((1,), float(xf[..., 0].numel()), device=xf.device)
        s = self.mesh.sum_distinct(torch.cat([xf.sum(dim=(0, 1, 2)),
                                              (xf * xf).sum(dim=(0, 1, 2)), count]))
        return s[:c] / s[-1], s[c:2 * c] / s[-1]

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        xf = x.float()
        if train:
            mean, ex2 = self._batch_stats(xf)
            var = torch.clamp(ex2 - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1.0 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1.0 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        return torch.relu((xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias)


def _norm(cin: int, bn: bool) -> nn.Module:
    return BatchNormRelu(cin) if bn else nn.GroupNorm(32, cin, eps=1e-5)


def norm_relu(x: torch.Tensor, norm: nn.Module, train: bool, mesh=None) -> torch.Tensor:
    """The norm + ReLU of x (whole or, under a model axis, this rank's
    channels). Under a model axis a GroupNorm that the axis divides gives
    this rank's channels (K4/K5 on them, 32 / tp groups), any other norm
    every channel."""
    bn = isinstance(norm, BatchNormRelu)
    if mesh is None or bn or norm.num_groups % mesh.tp or norm.num_channels % mesh.tp:
        x = _full(x, norm.weight.shape[0], mesh)
        return norm(x, train) if bn else gn_relu(x, norm)
    return group_norm_relu(_local(x, norm.num_channels, mesh), mesh.split_model(norm.weight, 0),
                           mesh.split_model(norm.bias, 0), norm.num_groups // mesh.tp,
                           norm.eps)


class UpsampleConv(nn.Module):
    """2x upsample + same-padded conv. Nearest-neighbour upsampling, where the
    1x1 shortcut runs the conv first (it commutes with a nearest upsample);
    or, with ``ref_ps``, the reference's pixel-shuffle upsampling first for
    every kernel size (its channel scramble does not commute with the 1x1
    conv)."""

    def __init__(self, cin: int, features: int, kernel_size: int, bias: bool = True,
                 ref_ps: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.ref_ps = ref_ps
        self.TorchConv_0 = nn.Conv2d(cin, features, kernel_size,
                                     padding=(kernel_size - 1) // 2, bias=bias)

    def forward(self, x, dtype=None, mesh=None):
        x = _full(x, self.TorchConv_0.in_channels, mesh)
        if self.ref_ps:
            return _conv(ref_pixel_shuffle_upsample_2x(x), self.TorchConv_0, dtype, mesh)
        if self.kernel_size == 1:
            return upsample_nearest_2x(_conv(x, self.TorchConv_0, dtype, mesh))
        return _conv(upsample_nearest_2x(x), self.TorchConv_0, dtype, mesh)


class ResBlockUp(nn.Module):
    """Upsampling residual block (reference DCResNet_models.py:19-38)."""

    def __init__(self, cin: int, features: int, kernel_size: int = 5, bn: bool = False,
                 ref_ps: bool = False):
        super().__init__()
        norm = "BatchNorm" if bn else "GroupNorm"
        self.UpsampleConv_0 = UpsampleConv(cin, features, 1, ref_ps=ref_ps)
        setattr(self, f"{norm}_0", _norm(cin, bn))
        self.UpsampleConv_1 = UpsampleConv(cin, features, kernel_size, bias=False,
                                           ref_ps=ref_ps)
        setattr(self, f"{norm}_1", _norm(features, bn))
        self.TorchConv_0 = nn.Conv2d(features, features, kernel_size,
                                     padding=(kernel_size - 1) // 2)
        self.norms = (f"{norm}_0", f"{norm}_1")

    def forward(self, x, dtype=None, train: bool = True, mesh=None):
        """The block's output: whole, or under a model axis this rank's
        channels when both branches end on them."""
        s = self.UpsampleConv_0(x, dtype, mesh)
        o = norm_relu(x, getattr(self, self.norms[0]), train, mesh)
        o = self.UpsampleConv_1(o, dtype, mesh)
        o = norm_relu(o, getattr(self, self.norms[1]), train, mesh)
        o = _conv(o, self.TorchConv_0, dtype, mesh)
        if o.shape[-1] != s.shape[-1]:
            features = self.TorchConv_0.out_channels
            return _full(o, features, mesh) + _full(s, features, mesh)
        return o + s


class DCResNetGenerator(nn.Module):
    family = "wgan"

    def __init__(self, channels: Sequence[int], first_filter_size: int,
                 z_dim: int = 128, out_ch: int = 3, n_classes: int = 0,
                 emb_mode: str = "concat", dtype=None, bn: bool = False,
                 ref_ps: bool = False):
        super().__init__()
        if emb_mode not in ("concat", "embed"):
            raise ValueError(emb_mode)
        self.channels = list(channels)
        self.first_filter_size = first_filter_size
        self.n_classes = n_classes
        self.emb_mode = emb_mode
        self.dtype = dtype
        f = first_filter_size
        embed = emb_mode == "embed" and n_classes > 0
        if embed:
            self.Embed_0 = nn.Embedding(n_classes, z_dim)
        self.TorchDense_0 = nn.Linear(z_dim + (0 if embed else n_classes),
                                      f * f * self.channels[0])
        for i, (cin, ch) in enumerate(zip(self.channels[:-1], self.channels[1:])):
            setattr(self, f"ResBlockUp_{i}", ResBlockUp(cin, ch, 5, bn, ref_ps))
        self.n_blocks = len(self.channels) - 1
        self.norm = "BatchNorm_0" if bn else "GroupNorm_0"
        setattr(self, self.norm, _norm(self.channels[-1], bn))
        self.TorchConv_0 = nn.Conv2d(self.channels[-1], out_ch, 3, padding=1)

    def forward(self, z: torch.Tensor, y: Optional[torch.Tensor] = None,
                train: bool = True, mesh=None):
        x = z
        if y is not None and self.n_classes > 0:
            if self.emb_mode == "embed":
                x = z * self.Embed_0.weight[y.long()]
            else:
                x = torch.cat([z, one_hot(y, self.n_classes)], dim=1)
        f = self.first_filter_size
        lin = self.TorchDense_0
        # Under a model axis the stem's slice is of the flat (h, w, c)
        # features, not of the channels: gathered before the reshape.
        x = _dense(x, lin, self.dtype, mesh).view(z.shape[0], f, f, self.channels[0])
        for i in range(self.n_blocks):
            x = getattr(self, f"ResBlockUp_{i}")(x, self.dtype, train, mesh)
        x = norm_relu(x, getattr(self, self.norm), train, mesh)
        x = _full(_conv(x, self.TorchConv_0, self.dtype, mesh), self.TorchConv_0.out_channels,
                  mesh)
        return torch.tanh(x.float())


class DCResNetDiscriminator(nn.Module):
    family = "wgan"

    def __init__(self, channels: Sequence[int], last_filter_size: int,
                 n_classes: int = 0, conditional_arch: str = "ACGAN", dtype=None):
        super().__init__()
        self.channels = list(channels)
        self.last_filter_size = last_filter_size
        self.n_classes = n_classes
        self.conditional_arch = conditional_arch
        self.dtype = dtype
        # The JAX D's effective_emb_mode: ACGAN ignores its input labels;
        # CGAN and WCGAN see them as constant one-hot planes.
        self.planes = n_classes > 1 and conditional_arch != "ACGAN"
        cins = [self.channels[0] + (n_classes if self.planes else 0)] + self.channels[1:-1]
        for i, (cin, ch) in enumerate(zip(cins, self.channels[1:])):
            setattr(self, f"TorchConv_{i}", nn.Conv2d(cin, ch, 5, stride=2, padding=2))
        self.n_convs = len(self.channels) - 1
        flat = last_filter_size * last_filter_size * self.channels[-1]
        self.wcgan = n_classes > 1 and conditional_arch == "WCGAN"
        if not self.wcgan:
            self.linOut = nn.Linear(flat, 1, bias=False)
        if n_classes > 1 and conditional_arch in ("ACGAN", "WCGAN"):
            self.linOutAux = nn.Linear(flat, n_classes)

    def convs(self) -> List[nn.Conv2d]:
        return [getattr(self, f"TorchConv_{i}") for i in range(self.n_convs)]

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                aux: bool = True, mesh=None):
        """(out, aux_out). A WCGAN's head is its critic: computed whatever
        ``aux`` says, with out = aux_out[y]."""
        o = x
        if self.planes and y is not None:
            planes = one_hot(y, self.n_classes)[:, None, None, :]
            o = torch.cat([o, planes.expand(x.shape[:3] + (self.n_classes,))], dim=-1)
        for conv in self.convs():
            o = F.leaky_relu(_conv(o, conv, self.dtype, mesh), 0.2)
        flat = _full(o, self.channels[-1], mesh).reshape(x.shape[0], -1)
        aux_out = None
        if hasattr(self, "linOutAux") and (aux or self.wcgan):
            aux_out = _dense(flat, self.linOutAux, self.dtype, mesh)
        if self.wcgan:
            return torch.sum(aux_out * one_hot(y, self.n_classes), dim=1, keepdim=True), aux_out
        return dense(flat, self.linOut.weight, None, self.dtype), aux_out


def d_leaves(D: DCResNetDiscriminator) -> List[str]:
    """D's state-dict names in the JAX leaf order (flax's sorted keys: the
    convs, then linOut, then linOutAux; bias before kernel)."""
    names = []
    for i in range(D.n_convs):
        names += [f"TorchConv_{i}.bias", f"TorchConv_{i}.weight"]
    if hasattr(D, "linOut"):
        names.append("linOut.weight")
    if hasattr(D, "linOutAux"):
        names += ["linOutAux.bias", "linOutAux.weight"]
    return names


# --- Presets (the JAX package's models/dcresnet.py:490-516) ---

def celeba_g64(**kw):
    return DCResNetGenerator(channels=[512, 512, 256, 128, 64], first_filter_size=4,
                             out_ch=3, **kw)


def celeba_d64(**kw):
    return DCResNetDiscriminator(channels=[3, 64, 128, 256, 512], last_filter_size=4, **kw)


def celeba_g48(**kw):
    return DCResNetGenerator(channels=[512, 512, 256, 128], first_filter_size=6,
                             out_ch=3, **kw)


def celeba_d48(**kw):
    return DCResNetDiscriminator(channels=[3, 128, 256, 512], last_filter_size=6, **kw)


def mnist_dcrn_g(**kw):
    return DCResNetGenerator(channels=[128, 128, 64], first_filter_size=7,
                             out_ch=1, **kw)


def mnist_dcrn_d(**kw):
    return DCResNetDiscriminator(channels=[1, 64, 128], last_filter_size=7, **kw)
