"""Ghost clipping for the MNIST vanilla discriminator's private pass.

For a Linear layer the per-sample weight gradient is the outer product of the
layer's output cotangent and its input, so its norm factorizes:
||g_W(i)|| = ||a(i)|| * ||c(i)||, ||g_b(i)|| = ||c(i)||. The clipped sum is
then one matrix product per layer, c^T diag(f) a, and no per-sample gradient
is formed (the JAX package's ops/ghost.py, Lee & Kifer 2020).

Params are torch state-dict names with torch layouts (weight [out, in]); the
leaf order of norms and stats is the JAX package's (models/mnist.py
D_LEAVES). The weighted sums run in full fp32: the caller on a CUDA device
keeps TF32 off.

Under a model axis (``mesh``, ``--tp``) ``lin1.weight`` may be this rank's
slice of lin1's output features (``sharded`` names it; the other leaves
never reach the size floor): lin1 computes this rank's features, gathered
over the model group, and the slice's per-sample squared norms
||a||^2 ||c_slice||^2 are summed over the model group, so each leaf's norm
enters the flat norm once; the weighted sum is this rank's slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from csl_gan_tpu_torch.models.common import one_hot
from csl_gan_tpu_torch.ops.grads import ClipStats, clip_factors, stats_from_norms


def vanilla_real_ghost(d_params: Dict[str, torch.Tensor], x: torch.Tensor,
                       y_onehot: Optional[torch.Tensor],
                       aux_labels: Optional[torch.Tensor],
                       aux_scalar: float, max_norm: float,
                       per_layer: bool = False, valid: Optional[torch.Tensor] = None,
                       stats_gather=None, mesh=None, sharded=()):
    """Clipped summed gradient of the per-sample real loss BCE(out_i, 1)
    [+ aux_scalar * CE_i]. The DP noise is pre-drawn and added by the caller
    (training/steps.py), as the epoch kernel consumes it. ``valid`` (the
    Poisson row mask, [B] fp32) scales the head cotangents, so a masked row
    has gradient and norm 0 (factor 1, contribution 0). The sum is over the
    rows given: a rank's rows under a data axis, which the caller reduces
    (``stats_gather``: see ``grads.stats_from_norms``).

    Returns (summed grads by param name, ClipStats, (out, aux_out))."""
    b = x.shape[0]
    a0 = x.reshape(b, -1)
    if y_onehot is not None:
        a0 = torch.cat([a0, y_onehot], dim=1)
    w1, b1 = d_params["lin1.weight"], d_params["lin1.bias"]
    w2, b2 = d_params["lin2.weight"], d_params["lin2.bias"]
    if set(sharded) - {"lin1.weight"}:
        raise NotImplementedError(f"vanilla ghost clipping with {sorted(sharded)} sharded")
    tp1 = "lin1.weight" in sharded
    if tp1:
        lo, hi = mesh.model_bounds(b1.shape[0])
        z1 = mesh.gather_model(a0 @ w1.T + b1[lo:hi], 1)
    else:
        z1 = a0 @ w1.T + b1
    h = torch.relu(z1)
    out = h @ w2.T + b2
    c_out = torch.sigmoid(out) - 1.0

    use_aux = aux_labels is not None and "linOutAux.weight" in d_params
    aux = c_aux = None
    if use_aux:
        wa, ba = d_params["linOutAux.weight"], d_params["linOutAux.bias"]
        aux = h @ wa.T + ba
        c_aux = aux_scalar * (torch.softmax(aux, dim=-1)
                              - one_hot(aux_labels, aux.shape[1]))
    if valid is not None:
        c_out = c_out * valid[:, None]
        if c_aux is not None:
            c_aux = c_aux * valid[:, None]
    c_h = c_out @ w2 + c_aux @ wa if use_aux else c_out @ w2
    c_z1 = c_h * (z1 > 0)

    sq_a0 = torch.sum(a0 ** 2, dim=1)
    sq_h = torch.sum(h ** 2, dim=1)
    sq_cz = torch.sum(c_z1 ** 2, dim=1)
    sq_co = torch.sum(c_out ** 2, dim=1)
    c_w1 = c_z1[:, lo:hi] if tp1 else c_z1
    sq_w1 = sq_a0 * torch.sum(c_w1 ** 2, dim=1) if tp1 else sq_a0 * sq_cz
    if tp1:
        sq_w1 = mesh.reduce_model(sq_w1)
    norms = [torch.sqrt(sq_cz), torch.sqrt(sq_w1),
             torch.sqrt(sq_co), torch.sqrt(sq_h * sq_co)]
    if use_aux:
        sq_ca = torch.sum(c_aux ** 2, dim=1)
        norms += [torch.sqrt(sq_ca), torch.sqrt(sq_h * sq_ca)]
    leaf_norms = torch.stack(norms)                          # [L, B]
    factors = clip_factors(leaf_norms, max_norm, per_layer)  # [L, B]

    def wsum_mat(a, c, f):      # sum_i f_i * outer(c_i, a_i), torch layout
        return c.T @ (a * f[:, None])

    def wsum_vec(c, f):
        return torch.sum(c * f[:, None], dim=0)

    summed = {
        "lin1.bias": wsum_vec(c_z1, factors[0]),
        "lin1.weight": wsum_mat(a0, c_w1, factors[1]),
        "lin2.bias": wsum_vec(c_out, factors[2]),
        "lin2.weight": wsum_mat(h, c_out, factors[3]),
    }
    if use_aux:
        summed["linOutAux.bias"] = wsum_vec(c_aux, factors[4])
        summed["linOutAux.weight"] = wsum_mat(h, c_aux, factors[5])
    stats: ClipStats = stats_from_norms(leaf_norms, factors, stats_gather)
    return summed, stats, (out, aux)
