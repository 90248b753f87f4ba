"""Convert the pytorch_fid InceptionV3 checkpoint to the npz that both
packages' Inception networks read (the port's counterpart of the root tool
convert_inception_weights.py; the same file comes out):

    python -m csl_gan_tpu_torch.convert_inception_weights \\
        pt_inception-2015-12-05-6726825d.pth fid_inception_v3.npz
    export FID_INCEPTION_WEIGHTS=$PWD/fid_inception_v3.npz

Keys keep the torch state-dict names; ``<block>.conv.weight`` goes from OIHW
to HWIO, the BatchNorm weight / bias / running_mean / running_var pass as
they are; the ``fc`` head and the ``num_batches_tracked`` buffers are
dropped (FID reads the pool3 features only).
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("src", help="pytorch_fid state dict (.pth)")
    ap.add_argument("dst", help="npz to write")
    args = ap.parse_args(argv)

    import torch

    from csl_gan_tpu_torch.tools.inception import param_shapes

    state = torch.load(args.src, map_location="cpu", weights_only=True)
    out = {}
    for name, shape in param_shapes().items():
        arr = state[name].detach().numpy()
        if name.endswith(".conv.weight"):
            arr = np.transpose(arr, (2, 3, 1, 0))  # OIHW -> HWIO
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
        out[name] = arr.astype(np.float32)
    np.savez_compressed(args.dst, **out)
    print(f"wrote {len(out)} arrays to {args.dst}")


if __name__ == "__main__":
    main()
