"""Reference (upstream torch) checkpoints -> the port's state (the port's copy
of the JAX package's training/ref_convert.py).

The reference's ``saves/{G|D}-N`` are torch pickles of ``{epoch,
model_state_dict, optimizer_state_dict, loss}`` (reference util.py:16-22).
This module maps them onto the port's state dicts, Adam moments and
BatchNorm buffers, so the port's tools and ``--resume_path`` take models
trained by the original code (``convert_reference_checkpoint.py``).

The port keeps torch's layouts: Linear weights ``[out, in]``, Conv2d weights
OIHW (convert.py). So every tensor passes as it is, under the port's module
name, except where the port's NHWC activations meet a reshape:
  - the DCResNet G stem (``linIn`` -> ``TorchDense_0``) reshapes its output
    to an image: torch views it as NCHW (C, ff, ff) (DCResNet_models.py:98),
    the port as NHWC (ff, ff, C), so the weight's rows and the bias are
    permuted (C, ff, ff) -> (ff, ff, C);
  - the DCResNet D heads (``linOut`` / ``linOutAux``) read the flattened conv
    stack: torch flattens NCHW (C, h, w) (DCResNet_models.py:137), the port
    NHWC (h, w, C), so the weight's columns are permuted (C, h, w) ->
    (h, w, C).
BatchNorm / GroupNorm ``weight`` / ``bias`` keep their names; a BatchNorm's
``running_mean`` / ``running_var`` go to the port's buffers ``mean`` /
``var``; ``num_batches_tracked`` is dropped. Adam's ``exp_avg`` /
``exp_avg_sq`` / ``step`` become the TrainState's mu / nu / count, through
the same per-tensor transforms; the optimizer's parameter index follows
torch's registration order, which is the order of the key maps below.

A converted DCResNet G runs with ``--ref_pixel_shuffle``: the reference's
upsampling scrambles channels (models/common.ref_pixel_shuffle_upsample_2x),
and the trained conv weights expect that arrangement.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

Entry = Tuple[str, str, Callable[[torch.Tensor], torch.Tensor]]


def _copy(t: torch.Tensor) -> torch.Tensor:
    return t


def _stem(c: int, ff: int):
    """G stem weight [C*ff*ff, in] (or bias [C*ff*ff]): rows from torch's
    (C, ff, ff) order to the port's (ff, ff, C)."""
    def tf(t: torch.Tensor) -> torch.Tensor:
        if t.shape[0] != c * ff * ff:
            raise ValueError(f"G stem has {t.shape[0]} outputs, not C*ff*ff = {c * ff * ff}")
        rest = tuple(t.shape[1:])
        return t.reshape((c, ff, ff) + rest).permute(
            (1, 2, 0) + tuple(range(3, 3 + len(rest)))).reshape((c * ff * ff,) + rest)
    return tf


def _flat_head(c: int, h: int):
    """D head weight [out, C*h*h]: columns from torch's (C, h, h) flatten to
    the port's (h, h, C)."""
    def tf(t: torch.Tensor) -> torch.Tensor:
        if t.shape[1] != c * h * h:
            raise ValueError(f"D head reads {t.shape[1]} inputs, not C*h*h = {c * h * h}")
        return t.reshape(t.shape[0], c, h, h).permute(0, 2, 3, 1).reshape(t.shape[0], -1)
    return tf


def g_key_map(opt, G) -> List[Entry]:
    """[(upstream key, port key, transform)] of G's parameters in torch
    registration order; the running statistics are ``g_stats_map``'s."""
    if opt.model == "Vanilla":
        return [(f"{m}.{leaf}", f"{m}.{leaf}", _copy)
                for m in ("lin1", "lin2") for leaf in ("weight", "bias")]
    # DCResNet generator (reference DCResNet_models.py:72-107).
    norm = "BatchNorm" if G.norm.startswith("BatchNorm") else "GroupNorm"
    entries: List[Entry] = []
    if G.n_classes > 1 and G.emb_mode == "embed":
        entries.append(("emb.weight", "Embed_0.weight", _copy))
    stem = _stem(G.channels[0], G.first_filter_size)
    entries += [("linIn.weight", "TorchDense_0.weight", stem),
                ("linIn.bias", "TorchDense_0.bias", stem)]
    for i in range(G.n_blocks):
        rb = f"ResBlockUp_{i}"
        entries += [
            (f"blocks.{i}.shortcut.conv.weight", f"{rb}.UpsampleConv_0.TorchConv_0.weight", _copy),
            (f"blocks.{i}.shortcut.conv.bias", f"{rb}.UpsampleConv_0.TorchConv_0.bias", _copy),
            (f"blocks.{i}.bn1.weight", f"{rb}.{norm}_0.weight", _copy),
            (f"blocks.{i}.bn1.bias", f"{rb}.{norm}_0.bias", _copy),
            (f"blocks.{i}.convUp.conv.weight", f"{rb}.UpsampleConv_1.TorchConv_0.weight", _copy),
            (f"blocks.{i}.bn2.weight", f"{rb}.{norm}_1.weight", _copy),
            (f"blocks.{i}.bn2.bias", f"{rb}.{norm}_1.bias", _copy),
            (f"blocks.{i}.conv.weight", f"{rb}.TorchConv_0.weight", _copy),
            (f"blocks.{i}.conv.bias", f"{rb}.TorchConv_0.bias", _copy),
        ]
    entries += [("bn.weight", f"{norm}_0.weight", _copy),
                ("bn.bias", f"{norm}_0.bias", _copy),
                ("convOut.weight", "TorchConv_0.weight", _copy),
                ("convOut.bias", "TorchConv_0.bias", _copy)]
    return entries


def g_stats_map(opt, G) -> List[Tuple[str, str]]:
    """[(upstream key, port buffer)] of a BatchNorm G's running statistics;
    empty for the vanilla and the GroupNorm generators."""
    if opt.model == "Vanilla" or not G.norm.startswith("BatchNorm"):
        return []
    entries = []
    for i in range(G.n_blocks):
        for tb, pb in (("bn1", "BatchNorm_0"), ("bn2", "BatchNorm_1")):
            entries += [(f"blocks.{i}.{tb}.running_mean", f"ResBlockUp_{i}.{pb}.mean"),
                        (f"blocks.{i}.{tb}.running_var", f"ResBlockUp_{i}.{pb}.var")]
    return entries + [("bn.running_mean", "BatchNorm_0.mean"),
                      ("bn.running_var", "BatchNorm_0.var")]


def d_key_map(opt, D) -> List[Entry]:
    """[(upstream key, port key, transform)] of D's parameters in torch
    registration order."""
    conditional = opt.conditional and opt.n_classes > 1
    if opt.model == "Vanilla":
        entries = [(f"{m}.{leaf}", f"{m}.{leaf}", _copy)
                   for m in ("lin1", "lin2") for leaf in ("weight", "bias")]
        if conditional and opt.conditional_arch == "ACGAN":
            entries += [("linOutAux.weight", "linOutAux.weight", _copy),
                        ("linOutAux.bias", "linOutAux.bias", _copy)]
        return entries
    # DCResNet discriminator (reference DCResNet_models.py:109-153).
    head = _flat_head(D.channels[-1], D.last_filter_size)
    entries = []
    for i in range(D.n_convs):
        entries += [(f"blocks.{i}.weight", f"TorchConv_{i}.weight", _copy),
                    (f"blocks.{i}.bias", f"TorchConv_{i}.bias", _copy)]
    if not (conditional and opt.conditional_arch == "WCGAN"):
        entries.append(("linOut.weight", "linOut.weight", head))
    if conditional and opt.conditional_arch in ("ACGAN", "WCGAN"):
        entries += [("linOutAux.weight", "linOutAux.weight", head),
                    ("linOutAux.bias", "linOutAux.bias", _copy)]
    return entries


def _tensor(v) -> torch.Tensor:
    return v.detach().cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(v)


def _set(out: Dict[str, torch.Tensor], key: str, value: torch.Tensor, src: str) -> None:
    if key not in out:
        raise KeyError(f"converted {src!r}: {key!r} is not in the model "
                       f"(has: {sorted(out)})")
    if tuple(out[key].shape) != tuple(value.shape):
        raise ValueError(f"converted {src!r} -> {key!r}: shape {tuple(value.shape)} != "
                         f"the model's {tuple(out[key].shape)}")
    out[key] = value.to(device=out[key].device, dtype=torch.float32).contiguous()


def convert_model_state(ref_sd: Mapping, key_map: Sequence[Entry],
                        like: Mapping[str, torch.Tensor],
                        stats_map: Sequence[Tuple[str, str]] = (),
                        stats_like: Optional[Mapping[str, torch.Tensor]] = None):
    """(params, stats): `like` (and `stats_like`) with every mapped upstream
    tensor in place, on their devices, fp32. Every mapped upstream key must
    exist, and an upstream key left over (other than ``num_batches_tracked``)
    raises: a weight dropped without a word would be a parity trap."""
    params = dict(like)
    consumed = set()
    for src, dst, tf in key_map:
        if src not in ref_sd:
            raise KeyError(f"reference state_dict is missing {src!r} (has: {sorted(ref_sd)})")
        _set(params, dst, tf(_tensor(ref_sd[src])), src)
        consumed.add(src)
    stats = None if stats_like is None else dict(stats_like)
    for src, dst in stats_map:
        if src not in ref_sd:
            raise KeyError(f"reference state_dict is missing {src!r}")
        _set(stats, dst, _tensor(ref_sd[src]), src)
        consumed.add(src)
    leftovers = [k for k in ref_sd
                 if k not in consumed and not k.endswith("num_batches_tracked")]
    if leftovers:
        raise KeyError(f"unmapped reference keys: {leftovers}")
    return params, stats


def convert_adam_state(ref_opt_sd: Optional[Mapping], key_map: Sequence[Entry],
                       like: Mapping[str, torch.Tensor]):
    """(mu, nu, count) from torch Adam's ``{state: {i: {step, exp_avg,
    exp_avg_sq}}}``, parameter i being key_map's entry i; a parameter without
    state keeps zero moments, count is the largest step. None when the
    checkpoint has no optimizer state (keep the fresh one)."""
    if not ref_opt_sd or not ref_opt_sd.get("state"):
        return None
    state = {int(k): v for k, v in ref_opt_sd["state"].items()}
    mu = {k: torch.zeros_like(v) for k, v in like.items()}
    nu = {k: torch.zeros_like(v) for k, v in like.items()}
    count = 0
    for i, (src, dst, tf) in enumerate(key_map):
        if i not in state:
            continue
        ent = state[i]
        count = max(count, int(_tensor(ent["step"])))
        _set(mu, dst, tf(_tensor(ent["exp_avg"])), f"{src}:exp_avg")
        _set(nu, dst, tf(_tensor(ent["exp_avg_sq"])), f"{src}:exp_avg_sq")
    return mu, nu, count
