"""Training orchestration: the host loop around the epoch kernel.

The port's counterpart of the JAX package's training/loop.py ``Trainer`` for
the MNIST conditional ACGAN path: the dataset lives on the device as one flat
table ``[x | one-hot | label]`` (bf16 under ``--bf16_table``, the default),
whole groups of epochs run through the epochs runner (one K1 launch per
epoch), and between groups the host steps the RDP accountant and writes
``log.csv`` and ``privacy_log.csv``.

Checkpoints, sample grids and SIGTERM handling are not ported yet: the save
and sample cadences are accepted and only announced.
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch

from csl_gan_tpu_torch import options as options_mod
from csl_gan_tpu_torch.data import init_data, n_batches
from csl_gan_tpu_torch.models.registry import init_models
from csl_gan_tpu_torch.ops import pallas_epoch as pe
from csl_gan_tpu_torch.privacy import make_accountant
from csl_gan_tpu_torch.training.logger import build_logger
from csl_gan_tpu_torch.training.segment_runner import EpochsRunner
from csl_gan_tpu_torch.training.steps import StepBuilder

# D leaves in torch parameter order (weight before bias) as indices into the
# JAX leaf order of models/mnist.py D_LEAVES: the per-layer log columns.
_TORCH_IDX = np.asarray([1, 0, 3, 2, 5, 4])


def resolve_device(opt) -> torch.device:
    """cuda:0 unless --platform cpu; without a CUDA device, raise."""
    if opt.platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; the port runs on the "
                           "GPU unless --platform cpu is given")
    return torch.device("cuda", 0)


class Trainer:
    MAX_EPOCH_GROUP = 100

    def __init__(self, opt):
        self.opt = opt
        self.device = resolve_device(opt)
        options_mod.save_opt(opt, os.path.join(opt.output_dir, "opt.txt"))
        self.G, self.D = init_models(opt, self.device)
        self.dataset = init_data(opt)
        self.n_batches = n_batches(self.dataset, opt.batch_size)
        self.builder = StepBuilder(opt, self.G, self.D)
        self.state = self.builder.init_state()
        self._setup_device_data()
        if not pe.supports(self.builder, opt.use_dp, 1):
            raise NotImplementedError("this configuration does not run on the "
                                      "ported epoch kernel")
        self.runner = EpochsRunner(self.builder, self.n_batches, opt.use_dp)
        self.accountant = make_accountant(opt) if opt.use_dp else None
        seed = int(opt.manual_seed)
        self.gen_perm = torch.Generator(self.device).manual_seed(seed * 2 + 1)
        self.gen = torch.Generator(self.device).manual_seed(seed * 2)

        self.logger = build_logger(opt, os.path.join(opt.output_dir, "log.csv"))
        self.privacy_log = None
        if opt.use_dp:
            self.privacy_log = open(os.path.join(opt.output_dir, "privacy_log.csv"), "a")
            self.privacy_writer = csv.writer(self.privacy_log)
            self.privacy_writer.writerow(["Epoch", "Epsilon"])
            self.privacy_log.flush()

    def _setup_device_data(self):
        """The flat [x | one-hot | label] table on the device. bf16 rounds to
        nearest even, as JAX's astype does, so the stored pixels equal the
        JAX package's table bit for bit; one-hot and labels are exact."""
        opt = self.opt
        imgs = np.asarray(self.dataset.images, np.float32)
        labels = np.asarray(self.dataset.labels, np.int64)
        self.builder.img_shape = imgs.shape[1:]
        flat = imgs.reshape(len(imgs), -1)
        eye = np.eye(opt.n_classes, dtype=np.float32)
        table = np.concatenate([flat, eye[labels],
                                labels.astype(np.float32)[:, None]], axis=1)
        t = torch.from_numpy(table).to(self.device)
        self.table = t.to(torch.bfloat16) if opt.bf16_table else t
        self.builder.labels_in_table = True
        self.builder.onehot_in_table = True

    def _group_epochs(self, epoch: int) -> int:
        """Epochs from `epoch` that can run as one group: extend while the
        would-be interior epoch has no log flush or epsilon-budget stop."""
        opt = self.opt
        budget = opt.epsilon_budget if opt.use_dp else None
        base_steps = self.accountant.steps if self.accountant else 0

        def has_event(j: int) -> bool:
            if opt.log_every_epochs > 0 and (j + 1) % opt.log_every_epochs == 0:
                return True
            if budget is not None:
                saved = self.accountant.steps
                self.accountant.steps = base_steps + (j - epoch + 1) * self.n_batches
                eps, _ = self.accountant.get_privacy_spent(opt.delta)
                self.accountant.steps = saved
                if eps > budget:
                    return True
            return False

        k = 1
        while (epoch + k < opt.n_epochs and k < self.MAX_EPOCH_GROUP
               and not has_event(epoch + k - 1)):
            k += 1
        return k

    def _fold(self, met: torch.Tensor, k: int) -> None:
        """Add a group's metric sums (one host read) to the logger stats."""
        m = met.cpu().numpy()
        s = self.logger.stats
        for name, slot in (("D Adv Loss", pe.M_D_ADV), ("D Real Loss", pe.M_D_REAL),
                           ("D Fake Loss", pe.M_D_FAKE), ("D Real Acc", pe.M_D_RACC),
                           ("D Fake Acc", pe.M_D_FACC),
                           ("D Real Aux Loss", pe.M_D_RAUX_LOSS),
                           ("D Real Aux Acc", pe.M_D_RAUX_ACC),
                           ("G Adv Loss", pe.M_G_ADV), ("G Aux Loss", pe.M_G_AUX),
                           ("G Aux Acc", pe.M_G_AUX_ACC)):
            if name in s:
                s[name] = s[name] + m[slot]
        if self.opt.use_dp:
            for name, lo in (("D Layer Grad Norm Means", pe.M_NORM_MEAN),
                             ("D Layer Grad Norm Stds", pe.M_NORM_STD),
                             ("D Layer Grad Norm Maxes", pe.M_NORM_MAX),
                             ("Grads Clipped", pe.M_FRAC)):
                s[name] = s[name] + m[lo:lo + 6][_TORCH_IDX]
            s["Clipping Params"] = s["Clipping Params"] + np.float32(
                self.n_batches * k * self.state.clipping)
        self.logger.log_g_iter += self.n_batches * k

    def _flush_log(self, epoch: int) -> None:
        lg = self.logger
        scale = 0 if lg.log_g_iter == 0 else lg.interval / lg.log_g_iter
        for stat in [k for k in lg.stats if k.startswith("G ")]:
            lg.stats[stat] = np.asarray(lg.stats[stat]) * scale
        lg.log_g_iter = 0
        lg.log(epoch, 100)
        if self.accountant is not None and self.accountant.steps > 0:
            eps, best_alpha = self.accountant.get_privacy_spent(self.opt.delta)
            print("({}, {})-DP for alpha={}".format(eps, self.opt.delta, best_alpha))

    def run(self) -> int:
        """Full training. Returns the last epoch index."""
        opt = self.opt
        print("\nStarting training...\n")
        print("Note: checkpoints (--save_every) and sample grids "
              "(--sample_every) are not ported yet; no saves/ or samples/ "
              "files are written.")
        self.logger.reset_stats()
        epoch = next_e = 0
        while next_e < opt.n_epochs:
            k = self._group_epochs(next_e)
            self.state, met = self.runner.run(self.state, self.table,
                                              self.gen_perm, self.gen, k)
            self._fold(met, k)
            stop = False
            for e in range(next_e, next_e + k):
                epoch = e
                if self.accountant is not None:
                    self.accountant.step(self.n_batches)
                if opt.log_every_epochs > 0 and (e + 1) % opt.log_every_epochs == 0:
                    self._flush_log(e)
                if opt.use_dp:
                    eps, _ = self.accountant.get_privacy_spent(opt.delta)
                    self.privacy_writer.writerow([e, eps])
                    self.privacy_log.flush()
                    if opt.epsilon_budget is not None and eps > opt.epsilon_budget:
                        stop = True
                        break
            if stop:
                break
            next_e = epoch + 1
        print("Finished training.")
        self.close()
        return epoch

    def close(self) -> None:
        self.logger.close()
        if self.privacy_log is not None:
            self.privacy_log.close()


def run_training(opt) -> Trainer:
    trainer = Trainer(opt)
    trainer.run()
    return trainer
