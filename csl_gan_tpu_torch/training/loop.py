"""Training orchestration: the host loop around the device runners.

The port's counterpart of the JAX package's training/loop.py ``Trainer``.
The dataset lives on the device: MNIST as one flat table ``[x | one-hot |
label]`` (bf16 under ``--bf16_table``, the default), CelebA as the decoded
uint8 images plus labels (normalised and randomly flipped after each
gather). Groups of whole epochs run through a runner, chosen by config:

  - the MNIST vanilla conditional ACGAN path (``pallas_epoch.supports`` and
    ``--pallas_epoch true``): the epochs runner, one K1 launch per epoch;
  - every other ported configuration: the step runner, whose gc D step takes
    the route the config selects (ghost, conv ghost through K2/K3, two-pass,
    or materialized per-sample gradients, fused through K6 under
    ``--pallas true``), with the DCResNet G forward and backward through
    K4/K5 and WGAN-GP on mean samples.
Options outside the ported slice are refused by ``options.check_ported``.

Between groups the host steps the RDP accountant and writes ``log.csv`` and
``privacy_log.csv`` (epsilon plus the mean samples' privacy cost).
Checkpoints, sample grids and SIGTERM handling are not ported yet: the save
and sample cadences are accepted and only announced.
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch

from csl_gan_tpu_torch import options as options_mod
from csl_gan_tpu_torch.data import Loader, init_data, n_batches
from csl_gan_tpu_torch.models.registry import init_models
from csl_gan_tpu_torch.ops import pallas_epoch as pe
from csl_gan_tpu_torch.privacy import MeanSampler, make_accountant
from csl_gan_tpu_torch.training.logger import build_logger
from csl_gan_tpu_torch.training.segment_runner import EpochsRunner, StepRunner
from csl_gan_tpu_torch.training.steps import StepBuilder

_D_STATS = (("d_adv_loss", "D Adv Loss"), ("d_real_loss", "D Real Loss"),
            ("d_fake_loss", "D Fake Loss"), ("d_real_acc", "D Real Acc"),
            ("d_fake_acc", "D Fake Acc"), ("d_real_aux_loss", "D Real Aux Loss"),
            ("d_real_aux_acc", "D Real Aux Acc"), ("penalty", "D Penalty"))
_G_STATS = (("g_adv_loss", "G Adv Loss"), ("g_aux_loss", "G Aux Loss"),
            ("g_aux_acc", "G Aux Acc"))
_NORM_STATS = (("norm_mean", "D Layer Grad Norm Means"),
               ("norm_std", "D Layer Grad Norm Stds"),
               ("norm_max", "D Layer Grad Norm Maxes"),
               ("frac_clipped", "Grads Clipped"))


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
        label1_prob = 0.5
        if opt.dataset == "CelebA" and opt.conditional and \
                self.dataset.label_true_count is not None:
            label1_prob = self.dataset.label_true_count / opt.train_set_size
        self.builder = StepBuilder(opt, self.G, self.D, label1_prob)
        self.state = self.builder.init_state()
        self._setup_mean_samples()
        self._setup_device_data()
        if opt.pallas_epoch and pe.supports(self.builder, opt.use_dp, 1):
            self.runner = EpochsRunner(self.builder, self.n_batches, opt.use_dp)
        else:
            self.runner = StepRunner(self.builder, self.n_batches, len(self.dataset),
                                     self._gather, self._u8_images,
                                     self.mean_sampler, self._dev_mean)
        # D leaves in torch parameter order (weight before bias) as indices
        # into the JAX leaf order: the per-layer log columns.
        leaves = list(self.builder.d_leaves)
        self._torch_idx = np.asarray([leaves.index(n) for n in self.D.state_dict()])
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

    def _setup_mean_samples(self):
        """Privatized per-class mean images as the penalty's public surrogate
        data (the JAX Trainer, training/loop.py:112-142)."""
        opt = self.opt
        self.mean_sampler = None
        self.mean_sample_privacy_cost = 0.0
        if opt.num_mean_samples <= 0:
            return
        print("Generating mean samples...")
        n_cls = opt.n_classes if opt.conditional else 1
        loader = Loader(self.dataset, batch_size=opt.mean_sample_size * n_cls,
                        seed=opt.manual_seed + 7)
        if opt.dataset == "CelebA" and opt.conditional:
            ltc = self.dataset.label_true_count
            scs = min(ltc, opt.train_set_size - ltc)
        elif opt.conditional:
            scs = opt.train_set_size / opt.n_classes
        else:
            scs = None
        self.mean_sampler = MeanSampler(
            dataloader=loader, dataset_size=opt.train_set_size,
            noise_std=opt.mean_sample_noise_std, num_samples=opt.num_mean_samples,
            mean_size=opt.mean_sample_size,
            res=28 if opt.dataset == "MNIST" else opt.im_size,
            ch=1 if opt.dataset == "MNIST" else 3, n_classes=n_cls,
            smallest_class_size=scs, seed=opt.manual_seed + 11)
        self.mean_sample_privacy_cost, _ = \
            self.mean_sampler.get_privacy_cost(target_delta=opt.delta)
        print("Privacy Cost from Mean Samples:", self.mean_sample_privacy_cost)

    def _setup_device_data(self):
        """The dataset on the device. MNIST: the flat [x | one-hot | label]
        table; bf16 rounds to nearest even, as JAX's astype does, so the
        stored pixels equal the JAX package's table bit for bit. CelebA: the
        uint8 images [N, H, W, 3] and the labels."""
        opt = self.opt
        self._dev_mean = None
        if self.mean_sampler is not None:
            self._dev_mean = torch.from_numpy(self.mean_sampler.mean_samples).to(self.device)
        labels = np.asarray(self.dataset.labels, np.int64)
        self._u8_images = self.dataset.images.dtype == np.uint8
        if self._u8_images:
            self.images = torch.from_numpy(np.ascontiguousarray(self.dataset.images)).to(self.device)
            self.labels = torch.from_numpy(labels).to(self.device)
            self.builder.img_shape = tuple(self.images.shape[1:])
            return
        imgs = np.asarray(self.dataset.images, np.float32)
        self.builder.img_shape = imgs.shape[1:]
        flat = imgs.reshape(len(imgs), -1)
        eye = np.eye(opt.n_classes, dtype=np.float32)
        table = np.concatenate([flat, eye[labels],
                                labels.astype(np.float32)[:, None]], axis=1)
        t = torch.from_numpy(table).to(self.device)
        self.table = t.to(torch.bfloat16) if opt.bf16_table else t
        self.builder.labels_in_table = True
        self.builder.onehot_in_table = True

    def _gather(self, idx: torch.Tensor):
        """(images, labels) of the rows idx of the device dataset."""
        if self._u8_images:
            return self.images[idx], self.labels[idx]
        x, y, _ = self.builder.gather_batch(self.table, idx)
        return x, y

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

    def _run_group(self, k: int) -> None:
        """k epochs through the runner, then their metric sums (one host read
        per group) into the logger stats."""
        s = self.logger.stats
        if isinstance(self.runner, EpochsRunner):
            self.state, met = self.runner.run(self.state, self.table,
                                              self.gen_perm, self.gen, k)
            m = met.cpu().numpy()
            d_sums = {key: m[slot] for key, slot in (
                ("d_adv_loss", pe.M_D_ADV), ("d_real_loss", pe.M_D_REAL),
                ("d_fake_loss", pe.M_D_FAKE), ("d_real_acc", pe.M_D_RACC),
                ("d_fake_acc", pe.M_D_FACC), ("d_real_aux_loss", pe.M_D_RAUX_LOSS),
                ("d_real_aux_acc", pe.M_D_RAUX_ACC))}
            for key, lo in (("norm_mean", pe.M_NORM_MEAN), ("norm_std", pe.M_NORM_STD),
                            ("norm_max", pe.M_NORM_MAX), ("frac_clipped", pe.M_FRAC)):
                d_sums[key] = m[lo:lo + len(self._torch_idx)]
            g_sums = {"g_adv_loss": m[pe.M_G_ADV], "g_aux_loss": m[pe.M_G_AUX],
                      "g_aux_acc": m[pe.M_G_AUX_ACC]}
            g_count = self.n_batches * k
        else:
            self.state, d_t, g_t, g_count = self.runner.run(self.state, self.gen_perm,
                                                            self.gen, k)
            d_sums = {key: v.cpu().numpy() for key, v in d_t.items()}
            g_sums = {key: v.cpu().numpy() for key, v in g_t.items()}
        for key, name in _D_STATS:
            if key in d_sums and name in s:
                s[name] = s[name] + d_sums[key]
        for key, name in _G_STATS:
            if key in g_sums and name in s:
                s[name] = s[name] + g_sums[key]
        if self.opt.use_dp:
            for key, name in _NORM_STATS:
                s[name] = s[name] + d_sums[key][self._torch_idx]
            clip = np.asarray(self.state.clipping, np.float32)
            if clip.ndim:       # per-layer thresholds: a torch-order column
                clip = clip[self._torch_idx]
            s["Clipping Params"] = s["Clipping Params"] + self.n_batches * k * clip
        self.logger.log_g_iter += g_count

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
            self._run_group(k)
            stop = False
            for e in range(next_e, next_e + k):
                epoch = e
                if self.accountant is not None:
                    self.accountant.step(self.n_batches)
                if opt.log_every_epochs > 0 and (e + 1) % opt.log_every_epochs == 0:
                    self._flush_log(e)
                if opt.use_dp:
                    # The budget stop reads the bare epsilon (reference
                    # train.py:592); the log adds the mean samples' cost.
                    eps, _ = self.accountant.get_privacy_spent(opt.delta)
                    self.privacy_writer.writerow([e, eps + self.mean_sample_privacy_cost])
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
