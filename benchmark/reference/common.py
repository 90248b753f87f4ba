"""Plain pieces shared by the references: operand precision, losses, Adam,
per-sample clipping and the replay of the training stream's draws.

Nothing here imports the program. Every function is written from the
published method (DP-SGD with per-sample clipping, Abadi et al. 2016; optax
Adam) and from the draw order that a configuration file states.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

Params = Dict[str, torch.Tensor]

# Precisions of a reference run: "fp32" (TF32 off), "tf32" (operands of every
# product rounded to 10 mantissa bits, fp32 products: what TF32 tensor cores
# compute), "bf16" (the configuration's own bf16 rules), "fp8" (bf16 rules
# with the operands of every product first quantized to float8 e4m3 with a
# per-tensor scale).


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """q in the forward, the identity in the backward (operands are rounded
    where a product reads them; the cotangent passes through)."""
    return x + (q - x).detach()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, nearest even), kept in fp32."""
    if x.dtype != torch.float32:
        return x
    # Veltkamp's split: c - (c - x) keeps the 24 - 13 = 11 leading bits of
    # the significand, rounded to nearest.
    c = x * 8193.0
    return _ste(x, c - (c - x))


def quant_fp8(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with a per-tensor scale (amax to 448), back in
    x's dtype."""
    xf = x.float()
    amax = xf.detach().abs().amax().clamp(min=1e-30)
    scale = amax / 448.0
    q = ((xf / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return _ste(x, q)


def operand(x: torch.Tensor, prec: str) -> torch.Tensor:
    """A product's operand as the precision reads it."""
    if prec == "tf32":
        return round_tf32(x)
    if prec == "fp8":
        return quant_fp8(x)
    return x


def compute_dtype(prec: str) -> Optional[torch.dtype]:
    """The dtype that convolutions compute in: bf16 under the bf16 rules."""
    return torch.bfloat16 if prec in ("bf16", "fp8") else None


def onehot(y: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot rows of labels y (vmap-safe: no data-dependent checks)."""
    return (y[..., None] == torch.arange(n, device=y.device)).float()


def bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Per-element binary cross entropy on logits."""
    return torch.nn.functional.softplus(logits) - logits * target


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row softmax cross entropy."""
    return -torch.log_softmax(logits.float(), dim=-1).gather(-1, labels[:, None].long())[:, 0]


def adam(p: Params, g: Params, m: Params, v: Params, t: int, lr: float, b1: float,
         b2: float, eps: float = 1e-8):
    """One Adam step (Kingma & Ba; optax scale_by_adam with eps_root 0)."""
    c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    new_p, new_m, new_v = {}, {}, {}
    for k in p:
        new_m[k] = b1 * m[k] + (1.0 - b1) * g[k]
        new_v[k] = b2 * v[k] + (1.0 - b2) * g[k] * g[k]
        u = (new_m[k] / c1) / (torch.sqrt(new_v[k] / c2) + eps)
        new_p[k] = p[k] - lr * u
    return new_p, new_m, new_v


def zeros_like(p: Params) -> Params:
    return {k: torch.zeros_like(x) for k, x in p.items()}


def clipped_sum(loss_one: Callable, params: Params, batch: Sequence[torch.Tensor],
                clip: float, chunk: int, norm_margin: float = 1.0) -> Params:
    """sum_i min(1, C / (margin * ||g_i||)) g_i over the per-sample gradients
    g_i of ``loss_one(params, *example)``, materialized ``chunk`` rows at a
    time; ||g_i|| is the flat norm over every leaf."""
    from torch.func import grad, vmap

    gfn = vmap(grad(loss_one), in_dims=(None,) + (0,) * len(batch))
    total = {k: torch.zeros_like(x, dtype=torch.float32) for k, x in params.items()}
    n = batch[0].shape[0]
    for lo in range(0, n, chunk):
        g = gfn(params, *(t[lo:lo + chunk] for t in batch))
        sq = sum(x.float().reshape(x.shape[0], -1).square().sum(dim=1) for x in g.values())
        f = torch.clamp(clip / (torch.sqrt(sq) * norm_margin + 1e-12), max=1.0)
        for k, x in g.items():
            total[k] += torch.einsum("b,bp->p", f, x.float().reshape(x.shape[0], -1)) \
                .reshape(x.shape[1:])
    return total


class Stream:
    """The device generator of a run's per-step draws, replayed: each method
    is one draw of the configuration's stated order."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        self.device = torch.device(device)

    def randn(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.gen, device=self.device,
                           dtype=torch.float32)

    def rand(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.gen, device=self.device)

    def randint(self, high: int, shape, dtype=torch.int64, low: int = 0) -> torch.Tensor:
        return torch.randint(low, high, tuple(shape), generator=self.gen,
                             device=self.device, dtype=dtype)

    def randperm(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.gen, device=self.device)


def leaf_noise(stream: Stream, shapes: List[tuple], std: float,
               lead: tuple = ()) -> List[torch.Tensor]:
    """std * N(0, 1), one draw per leaf in the stated leaf order."""
    return [stream.randn(lead + tuple(s)) * std for s in shapes]


def segment_means(per_step: List[Dict[str, float]], segments: Sequence[int]) -> List[dict]:
    """Each segment's mean of every loss over the steps of the segment that
    log it (a G loss only on the steps with a G update)."""
    out, start = [], 0
    for n in segments:
        part = per_step[start:start + n]
        keys = {k for step in part for k in step}
        out.append({k: sum(step[k] for step in part if k in step) /
                    sum(1 for step in part if k in step) for k in keys})
        start += n
    return out


def fp32_product(a: float, b: float) -> float:
    """a * b rounded to fp32, as a configuration states a noise std."""
    return float(torch.tensor(a, dtype=torch.float32) * torch.tensor(b, dtype=torch.float32))

