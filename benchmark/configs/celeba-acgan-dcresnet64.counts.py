"""Operations and bytes of the CelebA cells' work, from shapes.

``KERNELS[tag](call)`` gives (operations, bytes, peak) of one call of a
kernel's Python entry from the call's argument summary (harness/hooks.py).
Each input is counted read once and each output written once; element-wise
work (~10 operations an element) is left out of the GroupNorm and clip
kernels, whose bytes bound them.

``model_flops(d_steps, g_steps, batch)``: per D step and sample a G
forward for the fakes and D's forward and backward on the real and on the
fake rows (3 forwards' worth each); per G update and sample G's and D's
forward and backward. The WGAN-GP double backward is left out.
"""

from math import prod

# D: (input H, Cin, Cout) of the four 5x5 stride-2 convs; G: the convs of
# each ResBlockUp at its output size (shortcut 1x1, two 5x5), then the 3x3.
D_CONVS = ((64, 3, 64), (32, 64, 128), (16, 128, 256), (8, 256, 512))
G_BLOCKS = ((4, 512, 512), (8, 512, 256), (16, 256, 128), (32, 128, 64))


def forward_flops(nc: int = 2, lat: int = 128) -> dict:
    d = sum(2 * 25 * cin * cout * (h // 2) ** 2 for h, cin, cout in D_CONVS)
    d += 2 * 8192 * (1 + nc)
    g = 2 * (lat + nc) * 8192
    for h, cin, cout in G_BLOCKS:
        s = (2 * h) ** 2
        g += 2 * cin * cout * s + 2 * 25 * cin * cout * s + 2 * 25 * cout * cout * s
    g += 2 * 9 * 64 * 3 * 64 * 64
    return {"d": float(d), "g": float(g)}


def model_flops(d_steps: int, g_steps: int, batch: int) -> float:
    f = forward_flops()
    per_d = f["g"] + 2 * 3 * f["d"]
    per_g = 3 * f["g"] + 3 * f["d"]
    return float(batch * (d_steps * per_d + g_steps * per_g))


PRECISION_PEAK = "bf16"


def _conv_geometry(a: dict, c: dict, kh: int, kw: int):
    b, _, _, cin = a["shape"]
    _, ho, wo, cout = c["shape"]
    return b, ho * wo, kh * kw * cin, cout


def k2_ops(b: int, s: int, k: int, o: int) -> float:
    """The cheaper of the symmetric halves of both [S, S] Grams with their
    Frobenius product, and the direct order (each [K, O] product, then its
    squares)."""
    return min(float(b) * s * (s + 1) * (k + o + 1), 2.0 * b * k * o * (s + 1))


def k2(call: dict):
    a, c, kh, kw = call["args"][:4]
    b, s, k, o = _conv_geometry(a, c, kh, kw)
    nbytes = (prod(a["shape"]) + prod(c["shape"])) * a["itemsize"] + b * 4
    return k2_ops(b, s, k, o), float(nbytes), "bf16" if a["itemsize"] == 2 else "fp32"


def k3(call: dict):
    a, c, _, kernel_shape = call["args"][:4]
    kh, kw = kernel_shape[0], kernel_shape[1]
    b, s, k, o = _conv_geometry(a, c, kh, kw)
    nbytes = (prod(a["shape"]) + prod(c["shape"])) * a["itemsize"] + b * 4 + k * o * 4
    return 2.0 * b * s * k * o, float(nbytes), "bf16" if a["itemsize"] == 2 else "fp32"


def k4(call: dict):
    x, scale = call["args"][:2]
    return 0.0, float(2 * prod(x["shape"]) * x["itemsize"] + 2 * scale["shape"][0] * 4), "bytes"


def k5(call: dict):
    x, _, scale = call["args"][:3]
    return 0.0, float(3 * prod(x["shape"]) * x["itemsize"] + 4 * scale["shape"][0] * 4), "bytes"


def k6(call: dict):
    gs = call["args"][0]
    nbytes = 0.0
    for g in gs:
        b, p = g["shape"][0], prod(g["shape"][1:])
        nbytes += 4.0 * (b * p + b + p) + 12
    return 0.0, nbytes, "bytes"


KERNELS = {"k2": k2, "k3": k3, "k4": k4, "k5": k5, "k6": k6}
