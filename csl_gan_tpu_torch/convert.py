"""Weights and optimizer state carried between the JAX package and the port.

The JAX package's params are flax trees of numpy arrays: Dense ``kernel``
[in, out] and ``bias`` [out], with the vanilla G's layers auto-named
``TorchDense_0`` / ``TorchDense_1``. The port's are torch state dicts:
Linear ``weight`` [out, in] and ``bias``, with G's layers named ``lin1`` /
``lin2`` like D's. ``train_state_from_jax`` also carries Adam ``mu`` / ``nu``
/ ``count`` for D and G and the clip value; the ``*_to_jax`` functions invert
each mapping, so a test can compare in either layout.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from csl_gan_tpu_torch.training.steps import TrainState

G_MODULES = {"TorchDense_0": "lin1", "TorchDense_1": "lin2"}


def _module_map(kind: str) -> Dict[str, str]:
    if kind == "G":
        return dict(G_MODULES)
    if kind == "D":
        return {m: m for m in ("lin1", "lin2", "linOutAux")}
    raise ValueError(kind)


def params_from_jax(tree: Mapping, kind: str,
                    device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) -> torch state dict (fp32)."""
    mm = _module_map(kind)
    out = {}
    for mod, leaves in tree.items():
        name = mm[mod]
        for leaf, v in leaves.items():
            a = np.asarray(v, np.float32)
            if leaf == "kernel":
                out[f"{name}.weight"] = torch.tensor(np.ascontiguousarray(a.T), device=device)
            elif leaf == "bias":
                out[f"{name}.bias"] = torch.tensor(a, device=device)
            else:
                raise ValueError(f"unexpected leaf {mod}.{leaf}")
    return out


def params_to_jax(sd: Mapping[str, torch.Tensor], kind: str) -> Dict[str, Dict[str, np.ndarray]]:
    """torch state dict -> flax param tree of numpy arrays."""
    inv = {v: k for k, v in _module_map(kind).items()}
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for key, t in sd.items():
        name, leaf = key.rsplit(".", 1)
        a = t.detach().cpu().numpy().astype(np.float32)
        mod = out.setdefault(inv[name], {})
        if leaf == "weight":
            mod["kernel"] = np.ascontiguousarray(a.T)
        else:
            mod["bias"] = a
    return out


def train_state_from_jax(d_params, g_params, d_adam, g_adam, clipping,
                         device: Optional[torch.device] = None) -> TrainState:
    """The port's TrainState from the JAX one's pieces as numpy trees.
    ``d_adam`` / ``g_adam`` are (mu, nu, count) of optax's ScaleByAdamState."""
    d_mu, d_nu, d_count = d_adam
    g_mu, g_nu, g_count = g_adam
    return TrainState(
        d_params=params_from_jax(d_params, "D", device),
        g_params=params_from_jax(g_params, "G", device),
        d_mu=params_from_jax(d_mu, "D", device),
        d_nu=params_from_jax(d_nu, "D", device),
        g_mu=params_from_jax(g_mu, "G", device),
        g_nu=params_from_jax(g_nu, "G", device),
        d_count=int(d_count), g_count=int(g_count),
        clipping=float(np.asarray(clipping)))


def train_state_to_jax(state: TrainState) -> dict:
    """Inverse of train_state_from_jax: numpy trees keyed like its inputs."""
    return {
        "d_params": params_to_jax(state.d_params, "D"),
        "g_params": params_to_jax(state.g_params, "G"),
        "d_adam": (params_to_jax(state.d_mu, "D"), params_to_jax(state.d_nu, "D"),
                   state.d_count),
        "g_adam": (params_to_jax(state.g_mu, "G"), params_to_jax(state.g_nu, "G"),
                   state.g_count),
        "clipping": np.float32(state.clipping),
    }
