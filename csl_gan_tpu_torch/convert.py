"""Weights and optimizer state carried between the JAX package and the port.

The JAX package's params are flax trees of numpy arrays; the port's are torch
state dicts. Per leaf:

  - Dense ``kernel`` [in, out]          <-> Linear ``weight`` [out, in]
  - Conv ``kernel`` [kh, kw, cin, cout] <-> Conv2d ``weight`` [cout, cin, kh, kw]
  - GroupNorm ``scale``                 <-> ``weight``; ``bias`` <-> ``bias``
  - Embed ``embedding`` [n, d]          <-> Embedding ``weight`` [n, d]

Module paths: the vanilla MNIST G's auto-named ``TorchDense_0`` /
``TorchDense_1`` are ``lin1`` / ``lin2`` in the port (like D's); the DCResNet
pair keeps the flax names, and a flax conv's ``.../TorchConv_i/Conv_0`` is the
port's ``....TorchConv_i`` (models/dcresnet.py). ``train_state_from_jax`` also
carries Adam ``mu`` / ``nu`` / ``count`` for D and G, the clip value and the
IS scaling vector (a float placeholder or an fp32 tensor in leaf order) and
a BatchNorm G's running averages (``batch_stats``); the
``*_to_jax`` functions invert each mapping, so a test can compare in either
layout. The clip value is a float (flat clipping) or, under per-layer
clipping, the thresholds in leaf order, which both packages share: a tuple of
floats in the port, an fp32 vector in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from csl_gan_tpu_torch.training.steps import TrainState

VANILLA_G_MODULES = {"TorchDense_0": "lin1", "TorchDense_1": "lin2"}


def _is_dcresnet(names) -> bool:
    return any(n.startswith(("TorchConv_", "ResBlockUp_")) or ".TorchConv_" in n
               for n in names)


def _leaves(tree: Mapping, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def params_from_jax(tree: Mapping, kind: str,
                    device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) -> torch state dict (fp32). `kind` is
    "G" or "D" (it only matters for the vanilla G's module names)."""
    if kind not in ("G", "D"):
        raise ValueError(kind)
    vanilla_g = kind == "G" and not _is_dcresnet(tree.keys())
    out = {}
    for path, v in _leaves(tree):
        mods = [m for m in path[:-1] if m != "Conv_0"]
        if vanilla_g:
            mods = [VANILLA_G_MODULES[m] for m in mods]
        leaf = path[-1]
        a = np.asarray(v, np.float32)
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            name = "weight"
        elif leaf in ("scale", "embedding"):
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        else:
            raise ValueError(f"unexpected leaf {'/'.join(path)}")
        out[".".join(mods + [name])] = torch.tensor(np.ascontiguousarray(a), device=device)
    return out


def params_to_jax(sd: Mapping[str, torch.Tensor], kind: str) -> Dict:
    """torch state dict -> flax param tree of numpy arrays."""
    vanilla_g = kind == "G" and not _is_dcresnet(sd.keys())
    inv = {v: k for k, v in VANILLA_G_MODULES.items()}
    out: Dict = {}
    for key, t in sd.items():
        *mods, leaf = key.split(".")
        a = t.detach().cpu().numpy().astype(np.float32)
        if vanilla_g:
            mods = [inv[m] for m in mods]
        if mods[-1].startswith("TorchConv_"):
            mods = mods + ["Conv_0"]
        if leaf == "weight" and mods[-1].startswith("Embed_"):
            leaf = "embedding"
        elif leaf == "weight":
            if a.ndim == 4:
                leaf, a = "kernel", a.transpose(2, 3, 1, 0)
            elif a.ndim == 2:
                leaf, a = "kernel", a.T
            else:
                leaf = "scale"
        node = out
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(a)
    return out


def clipping_from_jax(clipping, like=None):
    """The JAX TrainState's clipping (fp32 scalar, or per-leaf vector) as the
    port's float or tuple of floats; as an fp32 tensor on ``like``'s device
    when ``like``, the state's clipping, is a tensor (adaptive clipping)."""
    c = np.asarray(clipping, np.float32)
    if isinstance(like, torch.Tensor):
        return torch.tensor(c, device=like.device)
    return float(c) if c.ndim == 0 else tuple(float(v) for v in c)


def clipping_to_jax(clipping) -> np.ndarray:
    """The port's clipping (float, tuple or tensor) as the JAX TrainState's
    fp32 scalar or per-leaf vector."""
    if isinstance(clipping, torch.Tensor):
        return clipping.detach().cpu().numpy().astype(np.float32)
    return np.asarray(clipping, np.float32)


def stats_from_jax(tree: Mapping, device: Optional[torch.device] = None
                   ) -> Dict[str, torch.Tensor]:
    """flax ``batch_stats`` (BatchNorm running ``mean`` / ``var``) -> the
    port's buffers by state-dict name."""
    return {".".join(path): torch.tensor(np.asarray(v, np.float32), device=device)
            for path, v in _leaves(tree)}


def stats_to_jax(stats: Mapping[str, torch.Tensor]) -> Dict:
    """Inverse of stats_from_jax: a nested tree of numpy arrays."""
    out: Dict = {}
    for key, t in stats.items():
        *mods, leaf = key.split(".")
        node = out
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = t.detach().cpu().numpy().astype(np.float32)
    return out


def scaling_vec_from_jax(v, device: Optional[torch.device] = None):
    """The JAX TrainState's scaling_vec (the fp32 0.0 placeholder, or the
    per-leaf vector) as the port's float or fp32 tensor on `device`."""
    a = np.asarray(v, np.float32)
    return float(a) if a.ndim == 0 else torch.tensor(a, device=device)


def scaling_vec_to_jax(v) -> np.ndarray:
    """Inverse of scaling_vec_from_jax: an fp32 numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy().astype(np.float32)
    return np.asarray(v, np.float32)


def train_state_from_jax(d_params, g_params, d_adam, g_adam, clipping,
                         device: Optional[torch.device] = None,
                         scaling_vec=0.0, g_batch_stats: Optional[Mapping] = None
                         ) -> TrainState:
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
        clipping=clipping_from_jax(clipping),
        scaling_vec=scaling_vec_from_jax(scaling_vec, device),
        g_batch_stats=stats_from_jax(g_batch_stats or {}, device))


def train_state_to_jax(state: TrainState) -> dict:
    """Inverse of train_state_from_jax: numpy trees keyed like its inputs."""
    return {
        "d_params": params_to_jax(state.d_params, "D"),
        "g_params": params_to_jax(state.g_params, "G"),
        "d_adam": (params_to_jax(state.d_mu, "D"), params_to_jax(state.d_nu, "D"),
                   state.d_count),
        "g_adam": (params_to_jax(state.g_mu, "G"), params_to_jax(state.g_nu, "G"),
                   state.g_count),
        "clipping": clipping_to_jax(state.clipping),
        "scaling_vec": scaling_vec_to_jax(state.scaling_vec),
        "g_batch_stats": stats_to_jax(state.g_batch_stats),
    }
