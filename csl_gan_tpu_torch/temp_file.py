"""Checkpoint smoke-loader (the port's counterpart of the root tool
temp_file.py): load G and D from a save of either package and run one
composed D(G(z, y), y) forward.

    python -m csl_gan_tpu_torch.temp_file <output_dir> -e <epochs> [-d cpu]
"""

import argparse
import time

import torch
from torch.func import functional_call

from csl_gan_tpu_torch import options
from csl_gan_tpu_torch.tools.saved_run import add_device_flag, load_run


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("path", type=str, help="Path to the output folder")
    parser.add_argument("-e", "--epochs", type=int, default=-1)
    add_device_flag(parser)
    args = parser.parse_args(argv)

    t0 = time.perf_counter()
    _, builder, state, epoch = load_run(options.add_slash(args.path), args.epochs,
                                        args.device)
    gen = torch.Generator(next(iter(state.g_params.values())).device).manual_seed(0)
    z, y = builder.gen_z(gen, 1), builder.gen_y(gen, 1)
    with torch.no_grad():
        img = builder.sample_images(state, z, y)
        out, _ = functional_call(builder.D, state.d_params, (img, y))
    print("Loaded epoch", epoch, "| D(G(z,y),y) =", out.float().cpu().numpy().ravel(),
          f"| {time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
    main()
