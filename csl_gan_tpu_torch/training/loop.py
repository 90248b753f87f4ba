"""Training orchestration: the host loop around the device runners.

The port's counterpart of the JAX package's training/loop.py ``Trainer``.
The dataset lives on the device: MNIST as one flat table ``[x | one-hot |
label]`` (the one-hot of conditional runs with 2..64 classes only; bf16
under ``--bf16_table``, the default; under ``--u8_table`` the uint8 ``[x *
255 | label]``, dequantized after each gather), CelebA as the uint8 images
of its decode-once cache plus labels (normalised and randomly flipped after
each gather). Under ``--host_loop`` CelebA stays on the host: each batch is
decoded, flipped and normalised there and copied to the card. Groups of
whole epochs run through a runner, chosen by config:

  - the MNIST vanilla conditional ACGAN path (``pallas_epoch.supports``,
    ``--pallas_epoch true``, no ``--host_loop``): the epochs runner, one K1
    launch per epoch, or per segment when a sub-epoch cadence cuts it;
  - every other ported configuration: the step runner, whose D step is that
    of the config's ``--dp_mode`` (gc by the route the config selects: ghost,
    conv ghost through K2/K3, two-pass, or materialized per-sample gradients,
    fused through K6 under ``--pallas true``; immediate sensitivity; trimmed
    mean or sign vote; the non-private step without it), with the DCResNet G
    forward and backward through K4/K5 and WGAN-GP on mean samples or
    class-matched public rows; under adaptive clipping each gc step takes
    its thresholds from a public or mean-sample batch; under ``--poisson``
    each DP step's batch is an exact Poisson draw over the device dataset
    (``StepBuilder.poisson_draw``), the epoch keeping its number of steps;
    under ``-pupd false`` the penalty is taken per sample on the real batch,
    inside each sample's clipped loss; under ``--backprop_clip`` (the
    vanilla model) the D clips its activations and cotangents and the
    derived bounds become the clipping vector; under ``--group_fakes`` a
    segment that starts on a cadence point runs by cadence groups, one G
    forward for each group's fakes.
With ``-pss`` the public split lives on the device beside the dataset.
``-wi`` runs that many non-private D steps (with their G steps) on public
rows or mean samples before the first epoch, on the step runner whatever
runner trains, then resets both Adam states; they land in the first log
row and the accountant counts none of them. A resumed run does not repeat
the warmup.

Between groups the host steps the accountant (RDP; zCDP for tm / sv) and
writes ``log.csv`` (under ``-dpm is`` with the interval's mean, least and
largest sensitivity),
``privacy_log.csv`` (epsilon plus the mean samples' privacy cost), the
fixed-z sample grids ``samples/{epoch}-{batch}.png`` on the sample cadence
and the ``saves/{G,D}-{epoch}`` checkpoints on the save cadence and at the
end (training/checkpoint.py). Save and sample epochs end a group, as log
epochs do. A ``--log_every`` or ``--sample_every`` below one epoch of
samples cuts each epoch into segments (the JAX Trainer's ``_epoch_scan``,
training/loop.py:591-655): the accountant steps per segment, and a cut on
the cadence writes its log row (with the JAX Trainer's epoch progress) or
grid. Under ``-p`` (training/profiling.py) ``torch.profiler`` traces the
run into ``profile/`` and each phase is timed. ``--stop_on_g_freeze N``
stops after the group that ends N log intervals in a row without a G
update (JAX training/loop.py:871-884).
``--resume_path`` continues a run of either package from its saves: a save
of the port carries the Trainer's generator states, so the resumed run
equals the uninterrupted one; a JAX save does not, and the generators are
then seeded from (seed, resume epoch). SIGTERM lets the current group
finish, then saves and returns (JAX training/loop.py:937-1039).

Under a data axis (``mesh``, parallel/mesh.py; one Trainer a rank) each
rank holds the whole device dataset, as the JAX Trainer replicates it, and
seeds its generators alike: every rank draws the same global permutation,
z, labels and noise, and the steps keep each rank's rows. The epochs runner
(K1) is left, as the JAX gate leaves it off one device. Rank 0 alone
prints the logs and writes ``log.csv``'s rows, ``privacy_log.csv``, the
sample grids and the saves; under ``--fsdp`` the state is gathered whole on
every rank first, so a save is the single-device one. A resume loads the
whole save on every rank, then shards it. The SIGTERM stop flag is
all-reduced at each group boundary, so every rank stops after the same
epoch and reaches the save. Under ``-p`` each rank writes its own trace.
"""

from __future__ import annotations

import csv
import os
import shutil
import signal
import threading
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import torch

from csl_gan_tpu_torch import options as options_mod
from csl_gan_tpu_torch.data import ArrayDataset, Loader, init_data, n_batches
from csl_gan_tpu_torch.models.registry import init_models
from csl_gan_tpu_torch.ops.backprop_clip import bpc_config_for
from csl_gan_tpu_torch.ops import pallas_epoch as pe
from csl_gan_tpu_torch.parallel.mesh import MeshContext
from csl_gan_tpu_torch.privacy import MeanSampler, accountant_from_state_dict, make_accountant
from csl_gan_tpu_torch.training import checkpoint
from csl_gan_tpu_torch.training.logger import build_logger
from csl_gan_tpu_torch.training.profiling import SectionTimer, TrainingProfile
from csl_gan_tpu_torch.training.segment_runner import EpochsRunner, PublicRows, StepRunner
from csl_gan_tpu_torch.training.steps import StepBuilder
from csl_gan_tpu_torch.utils.images import denorm_celeba, save_image_grid

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


def resolve_device(opt, mesh: MeshContext = None) -> torch.device:
    """The rank's device under a data axis; else cuda:0 unless --platform
    cpu; without a CUDA device, raise."""
    if mesh is not None and mesh.grouped:
        return mesh.device
    if opt.platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; the port runs on the "
                           "GPU unless --platform cpu is given")
    return torch.device("cuda", 0)


def snapshot_code(output_dir: str) -> None:
    """Copy the port's sources into output_dir/code (reference
    train.py:40-44)."""
    pkg = Path(__file__).resolve().parents[1]
    dst = os.path.join(output_dir, "code", pkg.name)
    if os.path.isdir(dst):
        shutil.rmtree(dst)
    shutil.copytree(pkg, dst, ignore=shutil.ignore_patterns("__pycache__"))


class Trainer:
    MAX_EPOCH_GROUP = 100

    def __init__(self, opt, mesh: MeshContext = None):
        self.opt = opt
        self.device = resolve_device(opt, mesh)
        self.mesh = mesh if mesh is not None else MeshContext(device=self.device)
        if opt.batch_size < self.mesh.dp:
            raise ValueError(f"-bs {opt.batch_size} gives a rank of the data axis's "
                             f"{self.mesh.dp} no row; raise -bs or use fewer ranks")
        options_mod.save_opt(opt, os.path.join(opt.output_dir, "opt.txt"))
        fresh = opt.resume_path is None
        if fresh:
            snapshot_code(opt.output_dir)
        if opt.backprop_clip:
            # The derived per-parameter bounds, times the batch size (the
            # summed per-sample grads are held to them), become the clipping
            # vector, applied verbatim, and its norm the flat threshold (JAX
            # training/loop.py:63-81, reference train.py:84-92); opt.txt keeps
            # the flags as given.
            cfg = bpc_config_for(opt)
            opt.clipping_param_per_layer = [c * opt.batch_size for c in cfg.grad_l2_bounds]
            opt.cpl_user_set = True
            opt.clipping_param = float(np.linalg.norm(opt.clipping_param_per_layer))
            print("BPC L2 Bounds:", cfg.grad_l2_bounds)
            print("BPC Backprop Clipping Params:", cfg.back_clip_params)
            print("BPC Forward Clipping Params:", cfg.input_clip_params)
        self.G, self.D = init_models(opt, self.device)
        self.dataset, self.public_dataset = init_data(opt)
        self.n_batches = n_batches(self.dataset, opt.batch_size)
        # --host_loop on CelebA: batches decoded on the host, one at a time.
        self.host_loader = None
        if not isinstance(self.dataset, ArrayDataset):
            if opt.poisson and opt.use_dp:
                raise Exception("--poisson requires an in-memory (device-resident) "
                                "dataset; this dataset is streamed from the host.")
            self.host_loader = Loader(self.dataset, opt.batch_size, seed=opt.manual_seed)
        # -p: the phases' wall-clock sections (training/profiling.py).
        self._timer = SectionTimer() if opt.profile_training else None
        label1_prob = 0.5
        if opt.dataset == "CelebA" and opt.conditional and \
                self.dataset.label_true_count is not None:
            label1_prob = self.dataset.label_true_count / opt.train_set_size
        self.builder = StepBuilder(opt, self.G, self.D, label1_prob, mesh=self.mesh)
        self.state = self.builder.init_state()
        self._setup_mean_samples()
        self._setup_device_data()
        # The step runner trains every configuration off K1 and runs the
        # warmup of every configuration.
        self.step_runner = StepRunner(self.builder, self.n_batches, len(self.dataset),
                                      self._gather, self._u8_images, self.mean_sampler,
                                      self._dev_mean, self.public, loader=self.host_loader,
                                      device=self.device)
        self.runner = self.step_runner
        # The JAX Trainer's host loop never takes its epoch kernel.
        if opt.pallas_epoch and not opt.host_loop and \
                pe.supports(self.builder, opt.use_dp, self.mesh.world):
            self.runner = EpochsRunner(self.builder, self.n_batches, opt.use_dp)
        # D leaves in torch parameter order (weight before bias) as indices
        # into the JAX leaf order: the per-layer log columns.
        leaves = list(self.builder.d_leaves)
        self._torch_idx = np.asarray([leaves.index(n) for n in self.D.state_dict()])
        self.accountant = make_accountant(opt) if opt.use_dp else None
        # The is sensitivity's extremes over the log interval (numpy).
        self._is_min = self._is_max = None
        # --stop_on_g_freeze: log intervals in a row without a G update.
        self._g_freeze_streak = 0
        self._g_freeze_stop = False
        seed = int(opt.manual_seed)
        self.gen_perm = torch.Generator(self.device).manual_seed(seed * 2 + 1)
        self.gen = torch.Generator(self.device).manual_seed(seed * 2)
        self.start_epoch = 0
        if not fresh and opt.resume_epochs > 0:
            self._resume(opt.resume_epochs)
        self.state = self.builder.shard_state(self.state)

        # The fixed sampling grid (reference train.py:256-261): z from the
        # seed alone, drawn on the CPU so both devices draw the same grid;
        # conditional runs take the labels 0..n_classes-1 repeated, z trimmed
        # to whole classes; unconditional runs no labels.
        z = torch.randn(opt.sample_num, opt.g_latent_dim,
                        generator=torch.Generator().manual_seed(seed))
        self.fixed_y = None
        if opt.conditional:
            reps = max(1, opt.sample_num // opt.n_classes)
            self.fixed_y = torch.arange(opt.n_classes).repeat(reps).to(self.device)
            z = z[: len(self.fixed_y)]
        self.fixed_z = z.to(self.device)

        # A resumed run appends to its logs without a new header.
        self.logger = build_logger(opt, os.path.join(opt.output_dir, "log.csv"),
                                   write_header=fresh)
        self.privacy_log = None
        if opt.use_dp and self.mesh.is_main:
            self.privacy_log = open(os.path.join(opt.output_dir, "privacy_log.csv"), "a")
            self.privacy_writer = csv.writer(self.privacy_log)
            if fresh:
                self.privacy_writer.writerow(["Epoch", "Epsilon"])
                self.privacy_log.flush()

    def _resume(self, n: int) -> None:
        """State, accountant and random streams from saves/{G,D}-n of a run
        of either package (JAX training/loop.py:166-176)."""
        opt = self.opt
        saves = os.path.join(opt.resume_path, "saves")
        self.state, _ = checkpoint.load_g(os.path.join(saves, f"G-{n}"), self.state)
        self.state, _, acc_state, run_state = checkpoint.load_d(
            os.path.join(saves, f"D-{n}"), self.state)
        self.start_epoch = n
        if acc_state and opt.use_dp:
            self.accountant = accountant_from_state_dict(acc_state)
        if run_state is not None and run_state.get("device") == self.device.type:
            checkpoint.set_generator_state(self.gen, run_state["gen"])
            checkpoint.set_generator_state(self.gen_perm, run_state["gen_perm"])
            if run_state.get("d_acc") is not None:
                self.step_runner.d_acc = torch.tensor(run_state["d_acc"], device=self.device)
            return
        why = ("holds no generator states (a save of the JAX package)" if run_state is None
               else f"holds generator states of a {run_state.get('device')} run")
        seeds = np.random.SeedSequence([int(opt.manual_seed), n]).generate_state(2, np.uint64)
        self.gen.manual_seed(int(seeds[0]))
        self.gen_perm.manual_seed(int(seeds[1]))
        print(f"Resume: saves/D-{n} {why}; the random streams are seeded from "
              f"(manual_seed {opt.manual_seed}, epoch {n}), a stream no fresh run "
              "draws.")

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
            dataloader=loader, save_path=os.path.join(opt.output_dir, "mean_samples"),
            dataset_size=opt.train_set_size,
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
        table, the one-hot only for conditional runs with 2..64 classes (JAX
        training/loop.py:349); bf16 rounds to nearest even, as JAX's astype
        does, so the stored pixels equal the JAX package's table bit for bit.
        Under ``--u8_table`` (JAX training/loop.py:295-335): the pixels times
        255, rounded, as uint8, with the label in a trailing uint8 column and
        no one-hot, for at most 255 classes, else the default table and a
        loud message. CelebA: the uint8 images [N, H, W, 3] and the labels;
        under ``--host_loop`` nothing. The public split (``PublicRows``):
        MNIST fp32 images, CelebA uint8 ones."""
        opt = self.opt
        self._dev_mean = None
        if self.mean_sampler is not None:
            self._dev_mean = torch.from_numpy(self.mean_sampler.mean_samples).to(self.device)
        self.public = None
        if self.public_dataset is not None:
            pub = self.public_dataset
            self.public = PublicRows(
                torch.from_numpy(np.array(pub.images)).to(self.device),
                torch.from_numpy(np.asarray(pub.labels, np.int64)).to(self.device),
                opt.n_classes if opt.conditional else 1)
        self._u8_images = False
        if self.host_loader is not None:
            self.builder.img_shape = (opt.im_size, opt.im_size, 3)
            return
        labels = np.asarray(self.dataset.labels, np.int64)
        self._u8_images = self.dataset.images.dtype == np.uint8
        if self._u8_images:
            if opt.u8_table:
                print("--u8_table requested but not applicable to this dataset (needs a "
                      "float image table and <=255 classes); falling back to the default "
                      "storage.")
            # The cache is memory-mapped read-only: copy it once for the upload.
            self.images = torch.from_numpy(np.array(self.dataset.images)).to(self.device)
            self.labels = torch.from_numpy(labels).to(self.device)
            self.builder.img_shape = tuple(self.images.shape[1:])
            return
        imgs = np.asarray(self.dataset.images, np.float32)
        self.builder.img_shape = imgs.shape[1:]
        if opt.u8_table and opt.n_classes > 255:
            print("--u8_table requested but not applicable to this dataset (needs a "
                  "float image table and <=255 classes); falling back to the default "
                  "storage.")
        elif opt.u8_table:
            p255 = imgs.reshape(len(imgs), -1) * 255.0
            if not (np.all(p255 == np.rint(p255)) and p255.min() >= 0 and p255.max() <= 255):
                print("Device image table stored uint8 (--u8_table): pixels are NOT "
                      "u8-exact; quantizing to 1/255 steps (same order as source u8 "
                      "quantization).")
            else:
                print("Device image table stored uint8 (--u8_table), <=1-ulp dequant u8/255 "
                      "after the gather.")
            table = np.concatenate([np.rint(np.clip(p255, 0, 255)).astype(np.uint8),
                                    labels.astype(np.uint8)[:, None]], axis=1)
            self.table = torch.from_numpy(table).to(self.device)
            self.builder.labels_in_table = True
            return
        cols = [imgs.reshape(len(imgs), -1)]
        onehot = opt.conditional and 2 <= opt.n_classes <= 64
        if onehot:
            cols.append(np.eye(opt.n_classes, dtype=np.float32)[labels])
        cols.append(labels.astype(np.float32)[:, None])
        t = torch.from_numpy(np.concatenate(cols, axis=1)).to(self.device)
        self.table = t.to(torch.bfloat16) if opt.bf16_table else t
        self.builder.labels_in_table = True
        self.builder.onehot_in_table = onehot

    def _gather(self, idx: torch.Tensor):
        """(images, labels) of the rows idx of the device dataset; one row
        gather of the flat table serves both."""
        if self._u8_images:
            return self.images[idx], self.labels[idx]
        x, y, _ = self.builder.gather_batch(self.table, idx)
        return x, y

    def _group_epochs(self, epoch: int) -> int:
        """Epochs from `epoch` that can run as one group: extend while the
        would-be interior epoch has no log, sample or save event and no
        epsilon-budget stop (JAX training/loop.py:721-740)."""
        opt = self.opt
        budget = opt.epsilon_budget if opt.use_dp else None
        base_steps = self.accountant.steps if self.accountant else 0

        def has_event(j: int) -> bool:
            if opt.log_every_epochs > 0 and (j + 1) % opt.log_every_epochs == 0:
                return True
            if opt.sample_every_epochs > 0 and (j + 1) % opt.sample_every_epochs == 0:
                return True
            if (j + 1) % opt.save_every == 0:
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

    def _section(self, name: str):
        return self._timer.section(name) if self._timer else nullcontext()

    def _force(self) -> None:
        """Under ``-p`` on the card, wait for the device, so that a section's
        time is its device work (the JAX Trainer's ``_force``)."""
        if self._timer is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _k1_sums(self, met: torch.Tensor, steps: int):
        """K1's metric vector, summed over ``steps`` steps, as the D and G
        metric sums of the step runner."""
        m = met.cpu().numpy()
        d_sums = {key: m[slot] for key, slot in (
            ("d_adv_loss", pe.M_D_ADV), ("d_real_loss", pe.M_D_REAL),
            ("d_fake_loss", pe.M_D_FAKE), ("d_real_acc", pe.M_D_RACC),
            ("d_fake_acc", pe.M_D_FACC), ("d_real_aux_loss", pe.M_D_RAUX_LOSS),
            ("d_real_aux_acc", pe.M_D_RAUX_ACC))}
        for key, lo in (("norm_mean", pe.M_NORM_MEAN), ("norm_std", pe.M_NORM_STD),
                        ("norm_max", pe.M_NORM_MAX), ("frac_clipped", pe.M_FRAC)):
            d_sums[key] = m[lo:lo + len(self._torch_idx)]
        if self.opt.dp_mode == "gc":
            # Constant flat clipping, one value a step.
            d_sums["clipping"] = steps * np.float32(self.state.clipping)
        g_sums = {"g_adv_loss": m[pe.M_G_ADV], "g_aux_loss": m[pe.M_G_AUX],
                  "g_aux_acc": m[pe.M_G_AUX_ACC]}
        return d_sums, g_sums, steps

    def _run_group(self, epoch: int, k: int) -> None:
        """Epochs epoch..epoch+k-1 through the runner, then their metric sums
        (one host read per group) into the logger stats."""
        with self._section("group_run"):
            if isinstance(self.runner, EpochsRunner):
                self.state, met = self.runner.run(self.state, self.table,
                                                  self.gen_perm, self.gen, k)
                sums = self._k1_sums(met, self.n_batches * k)
            else:
                self.state, d_t, g_t, g_count = self.runner.run(self.state, self.gen_perm,
                                                                self.gen, k)
                sums = ({key: v.cpu().numpy() for key, v in d_t.items()},
                        {key: v.cpu().numpy() for key, v in g_t.items()}, g_count)
            self._force()
        self._add_sums(*sums)

    def _epoch_cuts(self):
        """The segment ends of an epoch under a sub-epoch cadence: the
        batches k (1-based) whose k * batch_size is a multiple of a sub-epoch
        ``--log_every`` or ``--sample_every``, and the epoch's last (JAX
        training/loop.py:591-604)."""
        opt, n, bs = self.opt, self.n_batches, self.opt.batch_size
        log_in, sample_in = opt.log_every_epochs < 0, opt.sample_every_epochs < 0
        return sorted({k for k in range(1, n + 1)
                       if k == n or (log_in and (k * bs) % opt.log_every == 0)
                       or (sample_in and (k * bs) % opt.sample_every == 0)})

    def _run_segments(self, epoch: int) -> None:
        """One epoch cut into segments at its sub-epoch log and sample
        points (the JAX Trainer's ``_epoch_scan``): after each segment its
        sums go into the logger stats and the accountant steps by its
        length; a log point writes its row, with the epoch progress
        100 (cut - 1) / (train_set_size / batch_size), and a sample point
        its grid ``{epoch + 1}-{cut - 1}.png``. K1 runs each segment in one
        launch; the step runner by cadence groups under ``--group_fakes``
        when a segment starts on a cadence point."""
        opt, bs = self.opt, self.opt.batch_size
        runner = self.runner
        k1 = isinstance(runner, EpochsRunner)
        timed = self.device.type == "cuda"
        if timed:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        if k1:
            src = runner.epoch_perm(self.table, self.gen_perm)
        else:
            src, stds = runner.epoch_source(self.gen_perm), runner.noise_stds(self.state)
        start = 0
        for cut in self._epoch_cuts():
            with self._section("segment_run"):
                if k1:
                    self.state, met = runner.run_segment(self.state, self.table, src,
                                                         self.gen, start, cut)
                    sums = self._k1_sums(met, cut - start)
                else:
                    acc = [{}, {}, 0]
                    self.state = runner.run_segment(self.state, src, self.gen, start, cut,
                                                    acc, stds)
                    sums = ({key: v.cpu().numpy() for key, v in acc[0].items()},
                            {key: v.cpu().numpy() for key, v in acc[1].items()}, acc[2])
                self._force()
            self._add_sums(*sums)
            if self.accountant is not None:
                with self._section("accounting"):
                    self.accountant.step(cut - start)
            if opt.log_every_epochs < 0 and (cut * bs) % opt.log_every == 0:
                self._flush_log(epoch, 100 * (cut - 1) / (opt.train_set_size / bs))
            if opt.sample_every_epochs < 0 and (cut * bs) % opt.sample_every == 0:
                with self._section("sampling"):
                    self.sample(epoch, cut - 1)
            start = cut
        if timed:
            ev[1].record()
            runner.epoch_events = [ev]

    def _add_sums(self, d_sums, g_sums, g_count: int) -> None:
        """Metric sums (numpy) into the logger stats; the norm and clipping
        columns in torch parameter order (JAX training/loop.py:540-578)."""
        s = self.logger.stats
        for key, name in _D_STATS:
            if key in d_sums and name in s:
                s[name] = s[name] + d_sums[key]
        for key, name in _G_STATS:
            if key in g_sums and name in s:
                s[name] = s[name] + g_sums[key]
        if "is_sens" in d_sums:
            s["IS Mean"] = s["IS Mean"] + d_sums["is_sens"]
            lo, hi = d_sums["is_sens_min"], d_sums["is_sens_max"]
            self._is_min = lo if self._is_min is None else np.minimum(self._is_min, lo)
            self._is_max = hi if self._is_max is None else np.maximum(self._is_max, hi)
        if "Clipping Params" in s and "norm_mean" in d_sums:
            for key, name in _NORM_STATS:
                s[name] = s[name] + d_sums[key][self._torch_idx]
            clip = d_sums["clipping"]
            s["Clipping Params"] = s["Clipping Params"] + (
                clip[self._torch_idx] if np.ndim(clip) else clip)
        self.logger.log_g_iter += g_count

    def _warmup(self) -> None:
        """``-wi`` non-private D steps (and their G steps) on public rows or
        mean samples, then fresh Adam states for G and D (JAX
        training/loop.py:903-915): their metrics go into the current log
        interval, and the accountant counts none of them."""
        n = int(self.opt.warmup_iter or 0)
        if n <= 0:
            return
        self.state, d_t, g_t, g_count = self.step_runner.warmup(self.state, self.gen, n)
        self._add_sums({key: v.cpu().numpy() for key, v in d_t.items()},
                       {key: v.cpu().numpy() for key, v in g_t.items()}, g_count)
        self.state = self.builder.reset_optimizers(self.state)

    def _flush_log(self, epoch: int, progress: float = 100) -> None:
        with self._section("log_flush"):
            lg = self.logger
            if self._is_min is not None:
                # The interval's extremes, pre-scaled so that the logger's
                # average divides back to them (JAX training/loop.py:843-855).
                lg.stats["IS Min"] = self._is_min * lg.interval
                lg.stats["IS Max"] = self._is_max * lg.interval
                self._is_min = self._is_max = None
            scale = 0 if lg.log_g_iter == 0 else lg.interval / lg.log_g_iter
            for stat in [k for k in lg.stats if k.startswith("G ")]:
                lg.stats[stat] = np.asarray(lg.stats[stat]) * scale
            n_freeze = int(self.opt.stop_on_g_freeze or 0)
            if n_freeze > 0:
                self._g_freeze_streak = self._g_freeze_streak + 1 if lg.log_g_iter == 0 else 0
                if self._g_freeze_streak >= n_freeze and not self._g_freeze_stop:
                    self._g_freeze_stop = True
                    print(f"G frozen for {self._g_freeze_streak} consecutive logging intervals "
                          "(zero G updates; train_d_until_threshold gating) — stopping after "
                          f"this epoch group (--stop_on_g_freeze {n_freeze}).", flush=True)
            lg.log_g_iter = 0
            if not self.mesh.is_main:
                lg.reset_stats()
                return
            lg.log(epoch, progress)
            if self.accountant is not None and self.accountant.steps > 0:
                eps, best_alpha = self.accountant.get_privacy_spent(self.opt.delta)
                print("({}, {})-DP for alpha={}".format(eps, self.opt.delta, best_alpha))

    def sample(self, epoch: int, batch: int) -> None:
        """The fixed-z grid of G at the current state as
        samples/{epoch + 1}-{batch}.png, n_classes columns (one class a
        column when conditional); on rank 0 (every rank gathers --fsdp's
        params)."""
        state = self.builder.full_params(self.state)
        if not self.mesh.is_main:
            return
        imgs = self.builder.sample_images(state, self.fixed_z, self.fixed_y).cpu().numpy()
        if self.opt.dataset == "CelebA":
            imgs = denorm_celeba(imgs)
        save_image_grid(imgs, os.path.join(self.opt.output_dir, "samples",
                                           f"{epoch + 1}-{batch}.png"),
                        nrow=self.opt.n_classes)

    def _save(self, epoch_label: int, epoch: int) -> None:
        run_state = {"device": self.device.type,
                     "gen": checkpoint.generator_state(self.gen),
                     "gen_perm": checkpoint.generator_state(self.gen_perm)}
        if self.step_runner.d_acc is not None:
            run_state["d_acc"] = self.step_runner.d_acc.cpu().numpy()
        with self._section("checkpoint"):
            # Every rank gathers --fsdp's shards; rank 0 writes.
            state = self.builder.full_state(self.state)
            if not self.mesh.is_main:
                return
            checkpoint.save_pair(self.opt.output_dir, epoch_label, epoch, state,
                                 self.accountant.state_dict() if self.accountant else None,
                                 run_state, decay=self.builder.weight_decay != 0)

    def run(self) -> int:
        """Full training from ``start_epoch``. Returns the last epoch index.

        SIGTERM (what batch schedulers send before a kill) requests a clean
        stop: the current group of epochs finishes, the run prints
        "Preempted after epoch N", saves through the normal exit path and
        returns; ``--resume_path`` continues it with the accountant's steps.
        The handler is installed only on the main thread and the previous
        one restored on the way out. Under ``-p`` the run is traced by
        ``torch.profiler`` (written to ``profile/trace.json``), and the
        key-averages table and the sections' summary are printed at the
        end."""
        opt = self.opt
        main = self.mesh.is_main
        if main:
            print("\nStarting training...\n")
        self.logger.reset_stats()
        profile = None
        if self._timer is not None:
            name = "trace.json" if main else f"trace.rank{self.mesh.rank}.json"
            profile = TrainingProfile(opt.output_dir, self.device, name=name)
            profile.start()
        if self.start_epoch == 0:
            with self._section("warmup"):
                self._warmup()
        preempted = threading.Event()
        prev = None
        installed = threading.current_thread() is threading.main_thread()
        if installed:
            def on_sigterm(signum, frame):
                print("SIGTERM: finishing the current epoch group, then "
                      "checkpointing and exiting.", flush=True)
                preempted.set()
            prev = signal.signal(signal.SIGTERM, on_sigterm)
        try:
            epoch = self._epochs(preempted)
        finally:
            if installed:
                signal.signal(signal.SIGTERM, prev if prev is not None else signal.SIG_DFL)
            if profile is not None:
                table = profile.stop()
                if main:
                    print(table)
                print("Profile trace written to", profile.trace_path)
        if main:
            print("Finished training.")
        self._save(epoch + 1, opt.n_epochs)
        if self._timer is not None and main:
            print(self._timer.summary())
        self.close()
        return epoch

    def _epochs(self, preempted: threading.Event) -> int:
        """The epoch loop of ``run``; returns the last epoch run."""
        opt = self.opt
        # A sub-epoch cadence cuts every epoch: one epoch at a time, by
        # segments, the accountant stepped per segment.
        segments = opt.log_every_epochs < 0 or opt.sample_every_epochs < 0
        epoch = next_e = self.start_epoch
        while next_e < opt.n_epochs:
            if segments:
                k = 1
                self._run_segments(next_e)
            else:
                k = self._group_epochs(next_e)
                self._run_group(next_e, k)
            stop = False
            for e in range(next_e, next_e + k):
                if self.accountant is not None and not segments:
                    with self._section("accounting"):
                        self.accountant.step(self.n_batches)
                if opt.log_every_epochs > 0 and (e + 1) % opt.log_every_epochs == 0:
                    self._flush_log(e)
                if opt.sample_every_epochs > 0 and (e + 1) % opt.sample_every_epochs == 0:
                    with self._section("sampling"):
                        self.sample(e, self.n_batches - 1)
                if opt.use_dp:
                    # The budget stop reads the bare epsilon (reference
                    # train.py:592); the log adds the mean samples' cost.
                    eps, _ = self.accountant.get_privacy_spent(opt.delta)
                    if self.privacy_log is not None:
                        self.privacy_writer.writerow([e, eps + self.mean_sample_privacy_cost])
                        self.privacy_log.flush()
                    stop = opt.epsilon_budget is not None and eps > opt.epsilon_budget
                stop = stop or self._g_freeze_stop
                if (e + 1) % opt.save_every == 0:
                    self._save(e + 1, e)
                epoch = e
                if stop:
                    break
            # Every rank stops after the same epoch when one was signalled.
            if self.mesh.any(preempted.is_set()):
                if self.mesh.is_main:
                    print(f"Preempted after epoch {epoch}; saving and exiting "
                          "(resume with --resume_path).", flush=True)
                stop = True
            if stop:
                break
            next_e = epoch + 1
        return epoch

    def close(self) -> None:
        self.logger.close()
        if self.privacy_log is not None:
            self.privacy_log.close()


def run_training(opt, mesh: MeshContext = None) -> Trainer:
    trainer = Trainer(opt, mesh)
    trainer.run()
    return trainer
