"""DCResNet WGAN pair (the JAX package's models/dcresnet.py) as nn.Modules.

Generator: linear stem -> upsampling residual blocks (nearest 2x upsample +
5x5 conv; GroupNorm(32)+ReLU, the per-sample-grad-mode norm) -> GroupNorm+ReLU
-> 3x3 conv -> tanh. Discriminator: strided 5x5 convs with leaky-relu(0.2),
flatten, linear critic head ``linOut`` and, for ACGAN, the auxiliary
classifier head ``linOutAux``. family = "wgan".

Module names are the JAX package's (``TorchDense_0``, ``ResBlockUp_i``,
``UpsampleConv_0/1``, ``GroupNorm_0/1``, ``TorchConv_i``, ``linOut``,
``linOutAux``), so a state-dict key is the flax param path without its
``Conv_0`` level (convert.py). Activations are NHWC at every public function
and run as channels-last tensors inside.

``dtype`` is the compute dtype (``--bf16``): parameters stay fp32, convs take
bf16 inputs and weights and give bf16 outputs (flax nn.Conv), dense layers take
bf16-rounded inputs and weights with an fp32 product and output (TorchDense's
preferred_element_type), and tanh runs in fp32.

Differences from the JAX modules, by design:
  - The upsample-then-5x5-conv is computed the plain way (upsample, then
    ``F.conv2d``). The JAX package's phase form (``_PhaseConv``,
    ``collapse_phase_kernel``, ``phase_d2s``) and its ``--phase_gn4`` /
    ``--phase_carry`` variants are TPU layout choices with identical values.
  - Every GroupNorm+ReLU is the K4/K5 autograd function of
    ops/pallas_groupnorm.py.
  - Only the per-sample-grad (GroupNorm) generator, the concat label
    embedding and the ACGAN / unconditional discriminators are ported.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from csl_gan_tpu_torch.models.common import one_hot, upsample_nearest_2x
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


def _conv(x, conv: nn.Conv2d, dtype):
    return conv_nhwc(x, conv.weight, conv.bias, conv.stride, conv.padding, dtype)


def gn_relu(x: torch.Tensor, gn: nn.GroupNorm) -> torch.Tensor:
    return group_norm_relu(x, gn.weight, gn.bias, gn.num_groups, gn.eps)


class UpsampleConv(nn.Module):
    """Nearest 2x upsample + same-padded conv; the 1x1 shortcut runs the conv
    first (it commutes with the upsample)."""

    def __init__(self, cin: int, features: int, kernel_size: int, bias: bool = True):
        super().__init__()
        self.kernel_size = kernel_size
        self.TorchConv_0 = nn.Conv2d(cin, features, kernel_size,
                                     padding=(kernel_size - 1) // 2, bias=bias)

    def forward(self, x, dtype=None):
        if self.kernel_size == 1:
            return upsample_nearest_2x(_conv(x, self.TorchConv_0, dtype))
        return _conv(upsample_nearest_2x(x), self.TorchConv_0, dtype)


class ResBlockUp(nn.Module):
    """Upsampling residual block (reference DCResNet_models.py:19-38), GroupNorm form."""

    def __init__(self, cin: int, features: int, kernel_size: int = 5):
        super().__init__()
        self.UpsampleConv_0 = UpsampleConv(cin, features, 1)
        self.GroupNorm_0 = nn.GroupNorm(32, cin, eps=1e-5)
        self.UpsampleConv_1 = UpsampleConv(cin, features, kernel_size, bias=False)
        self.GroupNorm_1 = nn.GroupNorm(32, features, eps=1e-5)
        self.TorchConv_0 = nn.Conv2d(features, features, kernel_size,
                                     padding=(kernel_size - 1) // 2)

    def forward(self, x, dtype=None):
        s = self.UpsampleConv_0(x, dtype)
        o = gn_relu(x, self.GroupNorm_0)
        o = self.UpsampleConv_1(o, dtype)
        o = gn_relu(o, self.GroupNorm_1)
        o = _conv(o, self.TorchConv_0, dtype)
        return o + s


class DCResNetGenerator(nn.Module):
    family = "wgan"

    def __init__(self, channels: Sequence[int], first_filter_size: int,
                 z_dim: int = 128, out_ch: int = 3, n_classes: int = 0,
                 dtype=None):
        super().__init__()
        self.channels = list(channels)
        self.first_filter_size = first_filter_size
        self.n_classes = n_classes
        self.dtype = dtype
        f = first_filter_size
        self.TorchDense_0 = nn.Linear(z_dim + n_classes, f * f * self.channels[0])
        for i, (cin, ch) in enumerate(zip(self.channels[:-1], self.channels[1:])):
            setattr(self, f"ResBlockUp_{i}", ResBlockUp(cin, ch, 5))
        self.n_blocks = len(self.channels) - 1
        self.GroupNorm_0 = nn.GroupNorm(32, self.channels[-1], eps=1e-5)
        self.TorchConv_0 = nn.Conv2d(self.channels[-1], out_ch, 3, padding=1)

    def forward(self, z: torch.Tensor, y: Optional[torch.Tensor] = None):
        x = z
        if y is not None and self.n_classes > 0:
            x = torch.cat([z, one_hot(y, self.n_classes)], dim=1)
        f = self.first_filter_size
        lin = self.TorchDense_0
        x = dense(x, lin.weight, lin.bias, self.dtype).view(z.shape[0], f, f, self.channels[0])
        for i in range(self.n_blocks):
            x = getattr(self, f"ResBlockUp_{i}")(x, self.dtype)
        x = gn_relu(x, self.GroupNorm_0)
        x = _conv(x, self.TorchConv_0, self.dtype)
        return torch.tanh(x.float())


class DCResNetDiscriminator(nn.Module):
    family = "wgan"

    def __init__(self, channels: Sequence[int], last_filter_size: int,
                 n_classes: int = 0, conditional_arch: str = "ACGAN", dtype=None):
        super().__init__()
        self.channels = list(channels)
        self.n_classes = n_classes
        self.conditional_arch = conditional_arch
        self.dtype = dtype
        for i, (cin, ch) in enumerate(zip(self.channels[:-1], self.channels[1:])):
            setattr(self, f"TorchConv_{i}", nn.Conv2d(cin, ch, 5, stride=2, padding=2))
        self.n_convs = len(self.channels) - 1
        flat = last_filter_size * last_filter_size * self.channels[-1]
        self.linOut = nn.Linear(flat, 1, bias=False)
        if n_classes > 1 and conditional_arch == "ACGAN":
            self.linOutAux = nn.Linear(flat, n_classes)

    def convs(self) -> List[nn.Conv2d]:
        return [getattr(self, f"TorchConv_{i}") for i in range(self.n_convs)]

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                aux: bool = True):
        o = x
        for conv in self.convs():
            o = F.leaky_relu(_conv(o, conv, self.dtype), 0.2)
        flat = o.reshape(x.shape[0], -1)
        aux_out = None
        if aux and hasattr(self, "linOutAux"):
            aux_out = dense(flat, self.linOutAux.weight, self.linOutAux.bias, self.dtype)
        return dense(flat, self.linOut.weight, None, self.dtype), aux_out


def d_leaves(D: DCResNetDiscriminator) -> List[str]:
    """D's state-dict names in the JAX leaf order (flax's sorted keys: the
    convs, then linOut, then linOutAux; bias before kernel)."""
    names = []
    for i in range(D.n_convs):
        names += [f"TorchConv_{i}.bias", f"TorchConv_{i}.weight"]
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
