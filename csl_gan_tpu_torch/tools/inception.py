"""InceptionV3 for FID as an nn.Module (the port's counterpart of the JAX
package's tools/inception.py).

The pytorch_fid network (the reference's FID protocol, mem_inf_attack.py:416:
2048-d pool3 features), with its FID quirks: ``count_include_pad=False``
average pools in the A, C and E blocks, a max pool in ``Mixed_7c``'s pool
branch, BatchNorm eps 1e-3. Submodules carry pytorch_fid's names
(``Conv2d_1a_3x3.conv``, ``Conv2d_1a_3x3.bn``, ``Mixed_5b.branch1x1``, ...),
so a pytorch_fid state dict loads by name; the ``fc`` head is left out.

Weights come from the npz of the JAX package (keyed by those names, conv
weights HWIO), which ``convert_inception_weights.py`` of either package
writes from the standard ``pt_inception-2015-12-05`` checkpoint: point
``$FID_INCEPTION_WEIGHTS`` at it and tools/fid.py reports FID.

Input: NHWC float images in [0, 1] of any size; grey ones are repeated to 3
channels, resized to 299x299 bilinearly with half-pixel centres (with
antialiasing when scaling down, as ``jax.image.resize`` does) and mapped to
[-1, 1]. The convolutions are cuDNN's (``F.conv2d``; the JAX package leaves
them to XLA), run in fp32 with TF32 off on the card: FID is compared with
published numbers.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-3  # torchvision BasicConv2d's BatchNorm eps
SIZE = 299


class BasicConv2d(nn.Module):
    """Conv (no bias) + eval-mode BatchNorm + ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=EPS)

    def forward(self, x):
        bn = self.bn
        return F.relu(F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight,
                                   bn.bias, training=False, eps=EPS))


def _avg_pool_fid(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool_fid(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool_fid(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """pool_max: FIDInceptionE_2 (``Mixed_7c``), a max pool in the pool
    branch; else FIDInceptionE_1's average pool without the padding."""

    def __init__(self, cin: int, pool_max: bool):
        super().__init__()
        self.pool_max = pool_max
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = F.max_pool2d(x, 3, 1, 1) if self.pool_max else _avg_pool_fid(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class FIDInceptionV3(nn.Module):
    """images NHWC in [0, 1] -> [N, 2048] pool3 features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, pool_max=False)
        self.Mixed_7c = InceptionE(2048, pool_max=True)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2).float()
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        x = resize_299(x) * 2.0 - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """NCHW x to 299x299, bilinear with half-pixel centres; antialiased along
    a side that shrinks, as ``jax.image.resize`` is (a triangle kernel
    widened by the scale)."""
    down = x.shape[2] > SIZE or x.shape[3] > SIZE
    return F.interpolate(x, size=(SIZE, SIZE), mode="bilinear", align_corners=False,
                         antialias=down)


def _npz_name(name: str) -> bool:
    return name.endswith((".conv.weight", ".bn.weight", ".bn.bias", ".bn.running_mean",
                          ".bn.running_var"))


def param_shapes() -> Dict[str, tuple]:
    """Every weight's name and shape in the JAX package's npz layout (conv
    weights HWIO), in forward order (the JAX ``param_shapes``)."""
    shapes = {}
    with torch.device("meta"):
        sd = FIDInceptionV3().state_dict()
    for name, t in sd.items():
        if _npz_name(name):
            shapes[name] = tuple(t.permute(2, 3, 1, 0).shape) if t.ndim == 4 else tuple(t.shape)
    return shapes


def random_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX package's ``random_params(seed)`` bit for bit: conv weights
    N(0, 0.1) drawn in HWIO shape in forward order, BatchNorm scale and
    running variance 1, bias and running mean 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in param_shapes().items():
        if name.endswith(".conv.weight"):
            out[name] = rng.normal(0, 0.1, shape).astype(np.float32)
        elif name.endswith((".bn.weight", ".bn.running_var")):
            out[name] = np.ones(shape, np.float32)
        else:
            out[name] = np.zeros(shape, np.float32)
    return out


def scaled_random_params(seed: int = 7) -> Dict[str, np.ndarray]:
    """Random weights that keep the activations O(1) through the 94 layers
    (the rule of tests/test_inception_parity.py, drawn in the same order and
    shapes): conv weights N(0, 1/sqrt(fan in)) in HWIO, BatchNorm scale and
    running variance U(0.5, 1.5), bias and running mean N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in param_shapes().items():
        if name.endswith(".conv.weight"):
            out[name] = rng.normal(0, 1.0 / np.sqrt(shape[0] * shape[1] * shape[2]), shape)
        elif name.endswith((".bn.weight", ".bn.running_var")):
            out[name] = rng.uniform(0.5, 1.5, shape)
        else:
            out[name] = rng.normal(0, 0.1, shape)
    return {k: v.astype(np.float32) for k, v in out.items()}


def load_params(weights_path: str) -> Dict[str, np.ndarray]:
    data = np.load(weights_path)
    return {k: data[k] for k in data.files}


def build(params: Dict[str, np.ndarray], device: Optional[torch.device] = None
          ) -> FIDInceptionV3:
    """The network with `params` (npz layout) loaded, in eval mode, on
    `device`; raises unless every weight is given at its shape."""
    with torch.device("meta"):
        net = FIDInceptionV3()
    net = net.to_empty(device=device or "cpu")
    shapes = param_shapes()
    if set(params) != set(shapes):
        raise KeyError(f"Inception weights: missing {sorted(set(shapes) - set(params))}, "
                       f"unknown {sorted(set(params) - set(shapes))}")
    sd = {}
    for name, shape in shapes.items():
        a = np.asarray(params[name], np.float32)
        if a.shape != shape:
            raise ValueError(f"Inception weight {name} has shape {a.shape}, not {shape}")
        sd[name] = torch.from_numpy(a.transpose(3, 2, 0, 1) if a.ndim == 4 else a)
    for name, t in net.state_dict().items():
        if name.endswith("num_batches_tracked"):
            sd[name] = torch.zeros_like(t)
    net.load_state_dict(sd)
    return net.eval()


def features(net: FIDInceptionV3, images) -> np.ndarray:
    """[N, 2048] fp32 features of NHWC images in [0, 1]; on the card, the
    convolutions in fp32 with TF32 off."""
    dev = next(net.parameters()).device
    x = torch.as_tensor(np.asarray(images, np.float32), device=dev)
    cudnn = torch.backends.cudnn
    with torch.no_grad(), cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                                      deterministic=cudnn.deterministic, allow_tf32=False):
        return net(x).cpu().numpy()


def make_inception_features(weights_path: str, device=None):
    """feature_fn(images NHWC [0, 1]) -> [N, 2048] with the npz weights at
    `weights_path`, on the card unless `device` is "cpu" (raises when no
    CUDA device is visible; no fallback to the CPU)."""
    if device in ("cpu", torch.device("cpu")):
        dev = torch.device("cpu")
    elif not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; Inception features run on the "
                           "GPU unless the CPU is asked for")
    else:
        dev = torch.device("cuda", 0)
    net = build(load_params(weights_path), dev)
    return lambda images: features(net, images)
