"""Convert a reference (upstream torch) training output directory into one
that both packages read (the port's counterpart of the root tool
convert_reference_checkpoint.py, with the same arguments and outputs):

    python -m csl_gan_tpu_torch.convert_reference_checkpoint <ref_output_dir> \\
        -o <out_dir> [-e EPOCH [EPOCH ...]]

Reads the reference's ``opt.txt`` and its ``saves/{G|D}-N`` torch pickles
(reference util.py:16-22: {epoch, model_state_dict, optimizer_state_dict,
loss}) and writes ``opt.txt`` and the JAX package's msgpack
``saves/{G|D}-N`` (training/checkpoint.py). The tensors are mapped on the
host (training/ref_convert.py); nothing is computed, so no card is needed.

The written ``opt.txt`` is the reference's with ``ref_pixel_shuffle`` set
for DCResNet configs: the converted conv weights expect the reference's
channel-scrambling upsampling. The D saves carry the accountant rebuilt at
label x batches per epoch (the reference loses its accountant on save; its
budget_analysis.py makes the same reconstruction) and no generator states of
the port's (``torch_run_state``): a run resumed from them seeds its streams
from (seed, resume epoch) and says so.
"""

import argparse
import glob
import json
import os
import re
import sys
from argparse import Namespace
from dataclasses import replace


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("ref_dir", help="reference training output dir (opt.txt + saves/{G|D}-N)")
    ap.add_argument("-o", "--output_dir", required=True)
    ap.add_argument("-e", "--epochs", type=int, nargs="*", default=None,
                    help="checkpoint labels to convert; default: all found")
    args = ap.parse_args(argv)

    import torch

    from csl_gan_tpu_torch import options
    from csl_gan_tpu_torch.models.registry import init_models
    from csl_gan_tpu_torch.privacy import make_accountant
    from csl_gan_tpu_torch.training import checkpoint, ref_convert
    from csl_gan_tpu_torch.training.steps import StepBuilder

    opt_path = os.path.join(args.ref_dir, "opt.txt")
    with open(opt_path) as f:
        written = json.load(f)
    opt = options.load_opt(opt_path)
    if opt.model == "DeepConvResNet":
        opt.ref_pixel_shuffle = written["ref_pixel_shuffle"] = True

    G, D = init_models(opt, torch.device("cpu"))
    tmpl = StepBuilder(opt, G, D).init_state()
    g_map = ref_convert.g_key_map(opt, G)
    g_stats = ref_convert.g_stats_map(opt, G)
    d_map = ref_convert.d_key_map(opt, D)

    saves_in = os.path.join(args.ref_dir, "saves")
    if args.epochs:
        labels = list(args.epochs)
    else:
        labels = sorted(int(m.group(1)) for f in glob.glob(os.path.join(saves_in, "G-*"))
                        if (m := re.fullmatch(r"G-(\d+)", os.path.basename(f))))
    if not labels:
        sys.exit(f"no saves/G-N checkpoints found under {saves_in}")

    os.makedirs(os.path.join(args.output_dir, "saves"), exist_ok=True)
    options.save_opt(Namespace(**written), os.path.join(args.output_dir, "opt.txt"))

    spe = max(1, int(opt.train_set_size // opt.batch_size))
    for label in labels:
        gpath = os.path.join(saves_in, f"G-{label}")
        dpath = os.path.join(saves_in, f"D-{label}")
        # weights_only: the reference pickles hold only tensors and ints.
        g_ckpt = torch.load(gpath, map_location="cpu", weights_only=True)
        g_params, g_bstats = ref_convert.convert_model_state(
            g_ckpt["model_state_dict"], g_map, tmpl.g_params, g_stats, tmpl.g_batch_stats)
        state = replace(tmpl, g_params=g_params, g_batch_stats=g_bstats)
        g_adam = ref_convert.convert_adam_state(g_ckpt.get("optimizer_state_dict"), g_map,
                                                tmpl.g_params)
        if g_adam is not None:
            state = replace(state, g_mu=g_adam[0], g_nu=g_adam[1], g_count=g_adam[2])
        epoch = int(g_ckpt.get("epoch", label - 1))
        checkpoint.save_g(os.path.join(args.output_dir, "saves", f"G-{label}"), epoch, state)
        if os.path.exists(dpath):
            d_ckpt = torch.load(dpath, map_location="cpu", weights_only=True)
            d_params, _ = ref_convert.convert_model_state(d_ckpt["model_state_dict"], d_map,
                                                          tmpl.d_params)
            state = replace(state, d_params=d_params)
            d_adam = ref_convert.convert_adam_state(d_ckpt.get("optimizer_state_dict"), d_map,
                                                    tmpl.d_params)
            if d_adam is not None:
                state = replace(state, d_mu=d_adam[0], d_nu=d_adam[1], d_count=d_adam[2])
            acc_state = None
            if opt.use_dp:
                acc = make_accountant(opt)
                acc.step(label * spe)
                acc_state = acc.state_dict()
            checkpoint.save_d(os.path.join(args.output_dir, "saves", f"D-{label}"), epoch,
                              state, acc_state)
        print(f"converted G-{label}" + (f" + D-{label}" if os.path.exists(dpath) else " (no D)"))
    print(f"wrote {args.output_dir} ({len(labels)} checkpoint(s))")


if __name__ == "__main__":
    main()
