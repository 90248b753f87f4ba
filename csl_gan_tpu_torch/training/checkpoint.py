"""Checkpoints in the JAX package's ``saves/{G|D}-{epoch}`` layout.

The port's counterpart of the JAX package's training/checkpoint.py: the same
MessagePack payloads (``utils/msgpack.py`` writes them byte for byte as flax
does), so a save of either package loads in the other.

- ``model_state_dict``: the flax parameter tree (``convert.params_to_jax``;
  ``convert.params_from_jax`` on the way back).
- ``optimizer_state_dict``: optax.adam's state, ``{"0": {"count", "mu",
  "nu"}, "1": {}}`` with ``count`` an int32 scalar; under ``-wd`` D's is
  the state of the JAX package's chain (add_decayed_weights, scale_by_adam,
  scale), ``{"0": {}, "1": {"count", "mu", "nu"}, "2": {}}``.
- G: ``batch_stats``, a BatchNorm G's running averages (``{}`` for the
  other generators). D: ``clipping`` (an fp32 scalar, or the
  per-leaf vector in leaf order; under adaptive clipping the last step's
  thresholds), ``scaling_vec`` (the IS scaling, an fp32
  per-leaf vector in leaf order, or the fp32 ``0.0`` placeholder),
  ``accountant`` (the accountant's state dict, ``{}`` without DP).
- ``epoch`` and ``loss``.

The D save also carries one key of the port's own, ``torch_run_state``: the
device type, the Trainer's two ``torch.Generator`` states and the step
runner's threshold-gate carry, so a resumed run draws exactly what the
uninterrupted one would. The JAX package reads its keys by name and ignores
it. Keys are written sorted, as flax writes them.
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import Optional, Tuple

import numpy as np
import torch

from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch.training.steps import Params, TrainState
from csl_gan_tpu_torch.utils import msgpack

RUN_STATE_KEY = "torch_run_state"


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _adam(mu: Params, nu: Params, count: int, kind: str, decay: bool = False) -> dict:
    adam = {"count": np.asarray(count, np.int32),
            "mu": convert.params_to_jax(mu, kind),
            "nu": convert.params_to_jax(nu, kind)}
    return {"0": {}, "1": adam, "2": {}} if decay else {"0": adam, "1": {}}


def _write(path: str, payload: dict) -> None:
    """Write through a temporary file, so a save cut short never replaces
    the previous one."""
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(msgpack.packb(_sorted(payload)))
    os.replace(tmp, path)


def save_g(path: str, epoch: int, state: TrainState, loss: float = 0.0) -> None:
    _write(path, {
        "epoch": int(epoch),
        "model_state_dict": convert.params_to_jax(state.g_params, "G"),
        "batch_stats": convert.stats_to_jax(state.g_batch_stats),
        "optimizer_state_dict": _adam(state.g_mu, state.g_nu, state.g_count, "G"),
        "loss": float(loss),
    })


def save_d(path: str, epoch: int, state: TrainState,
           accountant_state: Optional[dict] = None,
           run_state: Optional[dict] = None, loss: float = 0.0,
           decay: bool = False) -> None:
    payload = {
        "epoch": int(epoch),
        "model_state_dict": convert.params_to_jax(state.d_params, "D"),
        "optimizer_state_dict": _adam(state.d_mu, state.d_nu, state.d_count, "D", decay),
        "clipping": convert.clipping_to_jax(state.clipping),
        "scaling_vec": convert.scaling_vec_to_jax(state.scaling_vec),
        "accountant": accountant_state or {},
        "loss": float(loss),
    }
    if run_state is not None:
        payload[RUN_STATE_KEY] = run_state
    _write(path, payload)


def save_pair(output_dir: str, epoch_label: int, epoch: int, state: TrainState,
              accountant_state: Optional[dict] = None,
              run_state: Optional[dict] = None, decay: bool = False) -> None:
    """saves/D-{epoch_label} and G-{epoch_label}; ``decay`` (``-wd``) writes
    D's optimizer state in the layout of the JAX package's decay chain."""
    saves = os.path.join(output_dir, "saves")
    os.makedirs(saves, exist_ok=True)
    save_d(os.path.join(saves, f"D-{epoch_label}"), epoch, state, accountant_state,
           run_state, decay=decay)
    save_g(os.path.join(saves, f"G-{epoch_label}"), epoch, state)


def _load(path: str) -> dict:
    with open(path, "rb") as f:
        p = msgpack.unpackb(f.read())
    for key in ("epoch", "model_state_dict", "optimizer_state_dict"):
        if key not in p:
            raise ValueError(f"{path}: not a checkpoint (no {key!r})")
    return p


def _params(tree: dict, kind: str, like: Params, path: str, what: str) -> Params:
    """A torch state dict from a flax tree, on `like`'s device and in its
    key order; raises unless names and shapes are `like`'s."""
    dev = next(iter(like.values())).device
    try:
        got = convert.params_from_jax(tree, kind, dev)
    except (KeyError, ValueError, AttributeError) as e:
        raise ValueError(f"{path}: {what} does not fit the model ({e!r})") from None
    if set(got) != set(like):
        raise ValueError(f"{path}: {what} has leaves {sorted(got)}, the model "
                         f"{sorted(like)}")
    for k, v in like.items():
        if got[k].shape != v.shape:
            raise ValueError(f"{path}: {what} {k} has shape {tuple(got[k].shape)}, "
                             f"the model {tuple(v.shape)}")
    return {k: got[k] for k in like}


def _opt_state(p: dict, kind: str, params: Params, path: str):
    """(mu, nu, count) of the save's Adam state: the entry of the optax chain
    that holds a count (the first of optax.adam's, the second of the decay
    chain's)."""
    chain = p["optimizer_state_dict"]
    adam = next((v for _, v in sorted(chain.items()) if "count" in v), None)
    if adam is None:
        raise ValueError(f"{path}: optimizer_state_dict holds no Adam state")
    return (_params(adam["mu"], kind, params, path, "Adam mu"),
            _params(adam["nu"], kind, params, path, "Adam nu"),
            int(np.asarray(adam["count"])))


def load_g(path: str, state: TrainState) -> Tuple[TrainState, int]:
    """(state with G's params, Adam state and batch statistics from the
    save, saved epoch)."""
    p = _load(path)
    g = _params(p["model_state_dict"], "G", state.g_params, path, "model_state_dict")
    mu, nu, count = _opt_state(p, "G", state.g_params, path)
    stats = state.g_batch_stats
    if stats or p.get("batch_stats"):
        dev = next(iter(g.values())).device
        got = convert.stats_from_jax(p.get("batch_stats") or {}, dev)
        if {k: v.shape for k, v in got.items()} != {k: v.shape for k, v in stats.items()}:
            raise ValueError(f"{path}: batch_stats {sorted(got)} do not fit the model's "
                             f"{sorted(stats)}")
        stats = {k: got[k] for k in stats}
    return replace(state, g_params=g, g_mu=mu, g_nu=nu, g_count=count,
                   g_batch_stats=stats), int(p["epoch"])


def load_d(path: str, state: TrainState
           ) -> Tuple[TrainState, int, Optional[dict], Optional[dict]]:
    """(state with D's params, Adam state, clipping and IS scaling from the
    save, saved epoch, accountant state dict or None, the port's run state or
    None)."""
    p = _load(path)
    d = _params(p["model_state_dict"], "D", state.d_params, path, "model_state_dict")
    mu, nu, count = _opt_state(p, "D", state.d_params, path)
    clipping = state.clipping
    if p.get("clipping") is not None:
        clipping = convert.clipping_from_jax(p["clipping"], like=state.clipping)
        if np.shape(p["clipping"]) != convert.clipping_to_jax(state.clipping).shape:
            raise ValueError(f"{path}: clipping {clipping} does not fit this "
                             f"configuration's {state.clipping}")
    scaling_vec = state.scaling_vec
    if p.get("scaling_vec") is not None:
        if np.shape(p["scaling_vec"]) != np.shape(convert.scaling_vec_to_jax(scaling_vec)):
            raise ValueError(f"{path}: scaling_vec {p['scaling_vec']} does not fit this "
                             f"configuration's {scaling_vec}")
        scaling_vec = convert.scaling_vec_from_jax(p["scaling_vec"], d[next(iter(d))].device)
    state = replace(state, d_params=d, d_mu=mu, d_nu=nu, d_count=count, clipping=clipping,
                    scaling_vec=scaling_vec)
    return state, int(p["epoch"]), p.get("accountant") or None, p.get(RUN_STATE_KEY)


def generator_state(gen: torch.Generator) -> bytes:
    return gen.get_state().numpy().tobytes()


def set_generator_state(gen: torch.Generator, state: bytes) -> None:
    gen.set_state(torch.frombuffer(bytearray(state), dtype=torch.uint8))
