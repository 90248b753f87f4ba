"""Operations and bytes of the MNIST cell's work, from shapes.

``KERNELS[tag](call)`` gives (operations, bytes, peak) of one call of a
kernel's Python entry, from the call's argument summary (harness/hooks.py:
a tensor is {"shape", "itemsize"}, a list of tensors a list of those).
``model_flops(d_steps, g_steps, batch)`` counts the model's forward and
backward passes (2 FLOPs a multiply-add): per D step and sample a G forward
for the fakes and D's forward and backward on the real and on the fake
rows (3 forwards' worth each); per G update and sample G's and D's forward
and backward.
"""

from math import prod

F, H = 784, 128


def k1_flops(n: int, bs: int, f: int, nc: int, lat: int, h: int) -> float:
    """Multiply-adds x2 of one K1 call of n steps: the products of the
    epoch kernel (element-wise work left out)."""
    a0, heads = f + nc, 2 * bs * h * (1 + nc)
    g_fwd = 2 * bs * h * (lat + nc) + 2 * bs * f * h
    real = 2 * bs * h * a0 + 2 * heads + 2 * bs * h * a0 + heads
    fake = 2 * bs * h * a0 + 2 * heads + 2 * bs * h * a0 + heads
    g_step = g_fwd + 2 * bs * h * a0 + 2 * heads + 3 * 2 * bs * f * h + 2 * bs * h * (lat + nc)
    return float(n * (g_fwd + real + fake + g_step))


def k1_bytes(n: int, bs: int, row_bytes: int, nc: int, lat: int, p_d: int, p_g: int,
             use_dp: bool) -> float:
    """Each input read once (table rows, z, one-hot labels, noise, params
    and moments), each output written once (params, moments, 40 metric
    sums)."""
    rand = 2 * n * bs * lat * 4 + n * bs * nc * 4
    noise = n * p_d * 4 if use_dp else 0
    return float(n * bs * row_bytes + rand + noise + 2 * 3 * (p_d + p_g) * 4 + 40 * 4)


def k1(call: dict):
    a = call["args"]
    rows, z_d, ohg, params = a[1], a[2], a[4], a[8]
    n, bs, lat = z_d["shape"]
    nc = ohg["shape"][-1]
    h, a0 = params[1]["shape"]
    p_d = sum(prod(p["shape"]) for p in params[:6])
    p_g = sum(prod(p["shape"]) for p in params[6:10])
    use_dp = call["kwargs"].get("use_dp", True)
    row_bytes = rows["shape"][1] * rows["itemsize"]
    return (k1_flops(n, bs, a0 - nc, nc, lat, h),
            k1_bytes(n, bs, row_bytes, nc, lat, p_d, p_g, use_dp), "fp32")


KERNELS = {"k1": k1}


def forward_flops(nc: int = 10, lat: int = 100) -> dict:
    return {"d": float(2 * H * (F + nc) + 2 * H * (1 + nc)),
            "g": float(2 * H * (lat + nc) + 2 * F * H)}


def model_flops(d_steps: int, g_steps: int, batch: int) -> float:
    f = forward_flops()
    per_d = f["g"] + 2 * 3 * f["d"]
    per_g = 3 * f["g"] + 3 * f["d"]
    return float(batch * (d_steps * per_d + g_steps * per_g))


PRECISION_PEAK = "fp32"
