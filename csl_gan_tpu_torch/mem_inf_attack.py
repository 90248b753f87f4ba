"""Membership-inference attack and FID of saved checkpoints of either
package (the port's counterpart of the root tool mem_inf_attack.py):

    python -m csl_gan_tpu_torch.mem_inf_attack --model_dir <dir> --model_name <name> \
        --checkpoints N [N...] [--compute_fid] [--generate_samples] [--save] [-d cpu]

Per checkpoint: the Hayes et al. 2018 sort-by-discriminator-value attack
(ASR over random train/nontrain subsets), optional sample generation to
PNGs, optional FID between real training data and generated samples
(InceptionV3 features on the tool's device when ``$FID_INCEPTION_WEIGHTS``
names the weights' npz, else pixel features; tools/fid.py), and a JSON stats
dump. A directory converted from the reference's saves
(``convert_reference_checkpoint``) loads like a run's. The nontrain set is
the MNIST test set, or the CelebA images after the training set
(--public_set_size of them).
"""

import argparse
from argparse import Namespace
import json
import os
import shutil
import time
import uuid

import numpy as np
import torch
from torch.func import functional_call

from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.data import init_data
from csl_gan_tpu_torch.tools import fid as fid_mod
from csl_gan_tpu_torch.tools.saved_run import add_device_flag, load_run
from csl_gan_tpu_torch.utils.images import denorm_celeba, save_image


def attack(attack_values_train, attack_values_nontrain, data_prop=0.1,
           rng=None) -> float:
    """Hayes et al. 2018: given a pool of which data_prop are training
    samples, sort by attack value and take the top n; ASR = precision
    (reference mem_inf_attack.py:29-59)."""
    rng = np.random.default_rng() if rng is None else rng
    n = int(1000 * data_prop)
    m = int(1000 * (1 - data_prop))
    sub_train = rng.choice(attack_values_train, size=n, replace=False)
    sub_non = rng.choice(attack_values_nontrain, size=m, replace=False)
    values = np.concatenate([sub_train, sub_non])
    indicators = np.concatenate([np.ones(n), np.zeros(m)])
    order = np.argsort(-values)
    return float(np.mean(indicators[order[:n]]))


def _datasets(opt):
    """((train images, labels), (nontrain images, labels)): the training set
    and the public split of ``init_data``; MNIST float in [0, 1], CelebA
    uint8."""
    # The arrays themselves, whether the run streamed its batches or not.
    train, public = init_data(Namespace(**{**vars(opt), "host_loop": False}))
    return (train.images, train.labels), (public.images, public.labels)


def apply_discriminator(opt, builder, state, images, labels, batch_size):
    """D-derived attack values: MNIST = softmax-max of the aux head
    (reference mem_inf_attack.py:69-84); CelebA = raw critic value (:87-101)."""
    dev = next(iter(state.d_params.values())).device
    values = []
    for i in range(0, len(images), batch_size):
        x = torch.from_numpy(np.ascontiguousarray(images[i:i + batch_size])).to(dev)
        if x.dtype == torch.uint8:
            x = x.float() / 127.5 - 1.0
        y = torch.from_numpy(np.asarray(labels[i:i + batch_size])).to(dev)
        with torch.no_grad():
            out, aux = functional_call(builder.D, state.d_params,
                                       (x, y if opt.conditional else None))
        if opt.dataset == "MNIST" and aux is not None:
            v = torch.softmax(aux.float(), dim=1).amax(dim=1)
        else:
            v = out.float().reshape(-1)
        values.append(v.cpu().numpy())
    return np.concatenate(values)


def _as_unit(imgs):
    """Training images as NHWC float in [0, 1] for PNGs."""
    return imgs.astype(np.float32) / 255.0 if imgs.dtype == np.uint8 else imgs


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--asr_iters", type=int, default=10000)
    parser.add_argument("--batch_size", type=int, default=1000)
    parser.add_argument("--compute_fid", default=False, action="store_true")
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--labels_dir", type=str, default=None)
    parser.add_argument("--data_prop", type=float, default=0.1)
    parser.add_argument("--fid_dir", type=str, default="fid/")
    parser.add_argument("--generate_samples", default=False, action="store_true")
    parser.add_argument("--checkpoint_max", type=int, default=None)
    parser.add_argument("--checkpoint_min", type=int, default=None)
    parser.add_argument("--checkpoint_step", type=int, default=None)
    parser.add_argument("--checkpoints", type=int, nargs="+", default=None)
    parser.add_argument("--model_dir", type=str, required=True)
    parser.add_argument("--model_name", type=str, required=True)
    parser.add_argument("--num_generated_samples", type=int, default=2048)
    parser.add_argument("--outputs_dir", type=str, default="outputs/")
    parser.add_argument("--public_set_size", type=int, default=10000)
    parser.add_argument("--real_samples_dir", type=str, default="real_samples_dir/")
    parser.add_argument("--samples_dir", type=str, default="samples/")
    parser.add_argument("--save", default=False, action="store_true")
    parser.add_argument("--tmp_dir", type=str, default="tmp/")
    parser.add_argument("--train_set_size", type=int, default=None)
    parser.add_argument("--values_dir", type=str, default="values/")
    parser.add_argument("--skip_asr", default=False, action="store_true")
    add_device_flag(parser)
    args = parser.parse_args(argv)

    t0 = time.perf_counter()
    run_id = uuid.uuid4().hex
    if all(v is not None for v in [args.checkpoint_max, args.checkpoint_min,
                                   args.checkpoint_step]) and \
            args.checkpoint_max > args.checkpoint_min > 0:
        args.checkpoints = list(range(args.checkpoint_min,
                                      args.checkpoint_max + args.checkpoint_step,
                                      args.checkpoint_step))
    if not args.checkpoints:
        raise ValueError("No checkpoints specified")

    model_path = os.path.join(args.model_dir, args.model_name)
    json_path = os.path.join(args.outputs_dir, f"{args.model_name}.json")
    checkpoint_stats = {}
    if os.path.exists(json_path):
        with open(json_path) as f:
            checkpoint_stats = json.load(f)

    data = None
    real_dir = None
    rng = np.random.default_rng(0)
    for ckpt in args.checkpoints:
        if str(ckpt) in checkpoint_stats:
            continue
        opt, builder, state, _ = load_run(model_path, ckpt, args.device)
        print(f"Loaded checkpoint {ckpt}")
        if data is None:
            if args.data_dir:
                opt.data_path = toptions.add_slash(args.data_dir)
            if args.labels_dir:
                opt.label_path = args.labels_dir
            opt.public_set_size = args.public_set_size
            if args.train_set_size is not None:
                opt.train_set_size = args.train_set_size
            print(f"Loading data for {args.model_name}...")
            data = _datasets(opt)
        (x_train, y_train), (x_non, y_non) = data
        if args.compute_fid and real_dir is None:
            # Real-data PNGs for FID (reference mem_inf_attack.py:261-273).
            real_dir = os.path.join(args.tmp_dir, args.real_samples_dir, opt.dataset.lower())
            os.makedirs(real_dir, exist_ok=True)
            if len(os.listdir(real_dir)) == 0:
                print("Saving real training data PNGs...")
                imgs = _as_unit(x_train[: args.num_generated_samples])
                for i in range(len(imgs)):
                    save_image(imgs[i], os.path.join(real_dir, f"{i:06d}.png"))
        checkpoint_stats[ckpt] = {}

        if not args.skip_asr:
            v_train = apply_discriminator(opt, builder, state, x_train, y_train,
                                          args.batch_size)
            v_non = apply_discriminator(opt, builder, state, x_non, y_non, args.batch_size)
            asr = float(np.mean([attack(v_train, v_non, args.data_prop, rng)
                                 for _ in range(args.asr_iters)]))
            checkpoint_stats[ckpt]["asr"] = asr
            print(f"ASR on {args.model_name}-{ckpt}: {asr:.2%}")

        fake_dir = None
        if args.generate_samples or args.compute_fid:
            n = args.num_generated_samples
            y_all = None
            if opt.conditional:
                per = n // opt.n_classes + 1
                y_all = np.concatenate([np.full(per, c) for c in range(opt.n_classes)])
                n = len(y_all)
            dev = next(iter(state.g_params.values())).device
            gen = torch.Generator(dev).manual_seed(1)
            fake_dir = os.path.join(args.samples_dir, args.model_name, f"G-{ckpt}", run_id)
            os.makedirs(fake_dir, exist_ok=True)
            count = 0
            for i in range(0, n, args.batch_size):
                bs = min(args.batch_size, n - i)
                yi = None if y_all is None else torch.from_numpy(y_all[i:i + bs]).to(dev)
                imgs = builder.sample_images(state, builder.gen_z(gen, bs), yi).cpu().numpy()
                if opt.dataset == "CelebA":
                    imgs = denorm_celeba(imgs)
                for img in imgs:
                    save_image(img, os.path.join(fake_dir, f"{count:04d}.png"))
                    count += 1
            print(f"Generated {count} samples.")

        if args.compute_fid:
            fid, label = fid_mod.calculate_fid_given_paths((real_dir, fake_dir), 50,
                                                           device=args.device)
            checkpoint_stats[ckpt][label] = fid
            print(f"Computed {label}: {fid:.2f}")
            fid_filedir = os.path.join(args.values_dir, args.fid_dir, args.model_name,
                                       f"G-{ckpt}")
            os.makedirs(fid_filedir, exist_ok=True)
            with open(os.path.join(fid_filedir, "fid.txt"), "w") as f:
                f.write(str(fid))

        if args.generate_samples and fake_dir:
            shutil.rmtree(fake_dir, ignore_errors=True)

    print(json.dumps(checkpoint_stats, indent=4))
    if args.save:
        os.makedirs(args.outputs_dir, exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(checkpoint_stats, f)
        print("Saved", json_path)
    print(f"mem_inf_attack: {time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
    main()
