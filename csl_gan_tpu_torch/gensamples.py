"""Sample PNGs from a saved generator of either package (the port's
counterpart of the root tool gensamples.py):

    python -m csl_gan_tpu_torch.gensamples <output_dir> -e <epochs> -n <num> [-bs N] [-d cpu]

Writes <output_dir>/G-<epochs>-samples/{1..num}.png. z and the labels are
drawn from a generator seeded 0 on the tool's device; full batches of -bs are
generated and the last one trimmed. The DCResNet G's norms run K4 on the card.
"""

import argparse
import os
import time

import torch

from csl_gan_tpu_torch import options
from csl_gan_tpu_torch.tools.saved_run import add_device_flag, load_run
from csl_gan_tpu_torch.utils.images import denorm_celeba, save_image


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("path", type=str)
    parser.add_argument("-e", "--epochs", type=int, default=-1)
    parser.add_argument("-n", "--num_samples", type=int, default=100)
    parser.add_argument("-bs", "--batch_size", type=int, default=50)
    add_device_flag(parser)
    args = parser.parse_args(argv)

    t0 = time.perf_counter()
    path = options.add_slash(args.path)
    output_dir = path + "G-" + str(args.epochs) + "-samples/"
    os.makedirs(output_dir, exist_ok=True)
    opt, builder, state, _ = load_run(path, args.epochs, args.device, with_d=False)
    gen = torch.Generator(next(iter(state.g_params.values())).device).manual_seed(0)
    count = 0
    for _ in range(-(-args.num_samples // args.batch_size)):
        z, y = builder.gen_z(gen, args.batch_size), builder.gen_y(gen, args.batch_size)
        imgs = builder.sample_images(state, z, y).cpu().numpy()
        if opt.dataset == "CelebA":
            imgs = denorm_celeba(imgs)
        for img in imgs[: args.num_samples - count]:
            count += 1
            save_image(img, os.path.join(output_dir, f"{count}.png"))
    print(f"Wrote {count} samples to {output_dir} in {time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
    main()
