#!/usr/bin/env python3
"""Smoke run of the PyTorch port (csl_gan_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one NVIDIA H100 and the CUDA
toolkit, it:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds every kernel of the ported path from the sources (one nvcc per
     source, in parallel) and prints the build time and ptxas report;
  3. holds each kernel against its plain PyTorch version on the card, at the
     main path's full width (bs 600, F 784, nc 10, latent 100, H 128), with
     seeded inputs: 5 steps with DP from the initial state, 5 without DP
     from a mid-training Adam state, and 5 with DP on an fp32 table; it
     also prints, without holding it to the bound, the gap of 5 steps
     without DP from zero Adam moments;
  4. drives the main path through its entry point: the port's Trainer on
     ``MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 60000`` (synthetic
     MNIST) for 3 epochs in one group, checks the kernel launch counts,
     finite losses and epsilon, and prints ms/epoch and samples/s;
  5. times each kernel and its plain version at the main path's shapes (one
     100-step epoch), prints the device time by CUDA kernel from
     torch.profiler, and prints one JSON ``kernels`` line;
  6. ends with ``{"ok": true, "device": {...}}`` as the last line.
Any failure raises or exits non-zero, and no result line is printed. It
needs no network and imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import csv
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Published peaks by the name nvidia-smi gives (NVIDIA data sheets, dense):
# fp32 outside the tensor cores, and device memory bandwidth, at the full
# power limit. The first match wins.
PEAKS = (("H100 PCIe", 51.2e12, 2.0e12), ("H100 NVL", 60.0e12, 3.9e12),
         ("H200", 67.0e12, 4.8e12), ("H100", 67.0e12, 3.35e12))

BS, F, NC, LATENT, H = 600, 784, 10, 100, 128
EPOCHS, CHECK_STEPS, TIME_STEPS = 3, 5, 100
# Kernel vs plain: both run the same fp32 arithmetic in another reduction
# order (tiled FFMA sums against PyTorch's kernels with TF32 off), so single
# results agree to ~1e-7 relative and, after 5 Adam steps, params and
# moments to a few 1e-6 with DP and ~1e-5 without (H100). 1e-4 leaves room
# for that drift and
# still fails on any wrong term, which moves a step's update by ~lr / |param|
# ~ 1e-2 relative.
REL_BOUND = 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def rel_l2(a, b) -> float:
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float((a - b).norm() / (b.norm() + 1e-30))


def k1_flops(n: int, bs: int = BS, f: int = F, nc: int = NC, lat: int = LATENT,
             h: int = H) -> float:
    """Multiply-adds x2 of one K1 epoch of n steps (the products of
    csrc/k1_epoch.cu, element-wise work left out)."""
    a0, heads = f + nc, 2 * bs * h * (1 + nc)
    g_fwd = 2 * bs * h * (lat + nc) + 2 * bs * f * h
    real = 2 * bs * h * a0 + 2 * heads + 2 * bs * h * a0 + heads
    fake = 2 * bs * h * a0 + 2 * heads + 2 * bs * h * a0 + heads
    g_step = (g_fwd + 2 * bs * h * a0 + 2 * heads
              + 3 * 2 * bs * f * h + 2 * bs * h * (lat + nc))
    return float(n * (g_fwd + real + fake + g_step))


def k1_bytes(n: int, p_d: int, p_g: int, use_dp: bool) -> float:
    """Bytes K1 must move for an epoch: each input read once (bf16 rows, z,
    one-hot labels, noise, params and moments), each output written once."""
    rows = n * BS * (F + NC + 1) * 2
    rand = 2 * n * BS * LATENT * 4 + n * BS * NC * 4
    noise = n * p_d * 4 if use_dp else 0
    state = 2 * 3 * (p_d + p_g) * 4
    return float(rows + rand + noise + state + 40 * 4)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not (REPO / "csl_gan_tpu_torch" / "ops" / "csrc").is_dir():
        fail(f"no csl_gan_tpu_torch sources beside {__file__}")
    sys.path.insert(0, str(REPO))

    # 1. The card.
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    peak_flops, peak_bytes = next(((f, b) for key, f, b in PEAKS if key in kind),
                                  (67.0e12, 3.35e12))
    # The plain versions are the fp32 reference: no TF32 in any product.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.data.mnist import synthetic_mnist
    from csl_gan_tpu_torch.models.common import one_hot
    from csl_gan_tpu_torch.models.mnist import D_LEAVES, G_LEAVES
    from csl_gan_tpu_torch.models.registry import init_models
    from csl_gan_tpu_torch.ops import _build, grads as gops
    from csl_gan_tpu_torch.ops import pallas_epoch as pe
    from csl_gan_tpu_torch.training.loop import Trainer
    from csl_gan_tpu_torch.training.steps import StepBuilder

    # 2. Build.
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(_build.KERNELS)} source(s)")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    out_root = REPO / "build" / "chip_smoke"

    def builder(use_dp: bool, tag: str) -> StepBuilder:
        argv = ["MNIST", "--conditional", "--sigma", "10", "-bs", str(BS),
                "-tss", "60000", "--manual_seed", "1", "--platform", "gpu",
                "-o", str(out_root / tag)] + (["-dpm", "gc"] if use_dp else [])
        opt = toptions.parse(argv)
        G, D = init_models(opt, dev)
        b = StepBuilder(opt, G, D)
        b.labels_in_table = b.onehot_in_table = True
        return b

    def inputs(b: StepBuilder, n: int, use_dp: bool, seed: int, warm: bool = False):
        imgs, labels = synthetic_mnist(n * BS, seed=seed)
        x = torch.from_numpy(imgs.reshape(n * BS, -1)).to(dev)
        y = torch.from_numpy(labels).to(dev)
        rows = torch.cat([x, one_hot(y, NC), y[:, None].float()], 1).to(torch.bfloat16)
        g = torch.Generator(dev).manual_seed(seed)
        z_d, z_g = b.gen_z(g, BS, (n,)), b.gen_z(g, BS, (n,))
        ohg = one_hot(b.gen_y(g, BS, (n,)), NC)
        st = b.init_state()
        noise = (gops.noise_like(g, [st.d_params[k] for k in D_LEAVES],
                                 gops.noise_std(b.sigma, st.clipping), lead=(n,))
                 if use_dp else None)
        params, mu, nu = pe.leaves_of(st)
        t = (0, 0)
        if warm:
            # Mid-training Adam state: seeded moments of the size the first
            # epochs leave (|grad| ~ 1e-3) and counts past an epoch.
            mu = [1e-3 * torch.randn(x.shape, generator=g, device=dev) for x in mu]
            nu = [(3e-3 * torch.randn(x.shape, generator=g, device=dev)) ** 2 + 1e-8
                  for x in nu]
            t = (300, 300)
        return (rows, z_d, z_g, ohg, noise, st.clipping, t, params, mu, nu)

    # 3. Kernel vs plain at full width: with DP from the initial state (the
    # main path's start), without DP from a mid-training Adam state. At count
    # 0 without noise, Adam's first update is ~sign(grad), so the few grad
    # elements within fp32 rounding of zero flip sign between any two
    # summation orders and the state drifts by 2 lr there; with nonzero
    # moments the update is smooth in the gradient, so the check holds to
    # the bound.
    max_abs = 0.0
    # (use_dp, table dtype, mid-training Adam state, held to the bound). The
    # third case stores the table in fp32 (--bf16_table false); the last is
    # only printed, to show the size of the sign sensitivity above.
    cases = ((True, torch.bfloat16, False, True), (False, torch.bfloat16, True, True),
             (True, torch.float32, False, True), (False, torch.bfloat16, False, False))
    for use_dp, row_dtype, warm, held in cases:
        b = builder(use_dp, f"check_dp{int(use_dp)}")
        ins = inputs(b, CHECK_STEPS, use_dp, seed=11, warm=warm)
        ins = (ins[0].to(row_dtype),) + ins[1:]
        outk = pe.epoch_kernel(b, *ins, use_dp=use_dp)
        outp = pe.epoch_plain(b, *ins, use_dp=use_dp)
        torch.cuda.synchronize()
        worst, abs_err, per_leaf = 0.0, 0.0, []
        names = [f"D.{k}" for k in D_LEAVES] + [f"G.{k}" for k in G_LEAVES]
        for group, gk, gp in zip(("param", "mu", "nu"), outk[:3], outp[:3]):
            for name, xk, xp in zip(names, gk, gp):
                r = rel_l2(xk, xp)
                per_leaf.append((r, f"{group} {name}"))
                worst = max(worst, r)
                abs_err = max(abs_err, float((xk - xp).abs().max()))
        per_leaf.sort(reverse=True)
        mk, mp = outk[3], outp[3]
        cont = [s for s in range(pe.MET_SLOTS) if s not in
                (pe.M_D_RACC, pe.M_D_FACC, pe.M_D_RAUX_ACC, pe.M_G_AUX_ACC)
                and not pe.M_FRAC <= s < pe.M_FRAC + 6]
        met_rel = rel_l2(mk[cont], mp[cont])
        # Accuracy and clipped-share slots count samples; one sample on the
        # other side of a threshold moves a step's value by 100/bs (or 1/bs).
        count_gap = float(max((mk - mp)[[pe.M_D_RACC, pe.M_D_FACC,
                                          pe.M_D_RAUX_ACC, pe.M_G_AUX_ACC]].abs().max(),
                              100.0 * (mk - mp)[pe.M_FRAC:pe.M_FRAC + 6].abs().max()))
        print(f"kernel vs plain (dp={use_dp}, rows {row_dtype}, "
              f"{'mid-training' if warm else 'zero'} moments, {CHECK_STEPS} steps): "
              f"max rel l2 state {worst:.3e}, metrics {met_rel:.3e}, count slots "
              f"{count_gap:.3e}, max abs {abs_err:.3e} "
              + (f"(bound {REL_BOUND:g})" if held else "(printed only)"))
        print("  worst leaves: " + ", ".join(f"{n} {r:.2e}" for r, n in per_leaf[:3]))
        if held and not (worst < REL_BOUND and met_rel < REL_BOUND
                         and count_gap <= 2 * 100.0 * CHECK_STEPS / BS):
            fail(f"K1 disagrees with its plain version (dp={use_dp})")
        if not all(torch.isfinite(x).all() for g in outk[:3] for x in g):
            fail("K1 produced non-finite state")
        if held:
            max_abs = max(max_abs, abs_err, float((mk - mp)[cont].abs().max()))

    # 4. The main path through its entry point.
    e = EPOCHS
    opt = toptions.parse(["MNIST", "--conditional", "-dpm", "gc", "--sigma", "10",
                          "-bs", str(BS), "-tss", "60000", "-ne", str(e),
                          "--log_every", str(60000 * e), "--manual_seed", "1",
                          "-o", str(out_root / "train")])
    tr = Trainer(opt)
    pe.epoch_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pe.epoch_kernel.launches
    if launches != e:
        fail(f"K1 launched {launches} times on the main path, expected {e}")
    ep_ms = [a.elapsed_time(b) for a, b in tr.runner.epoch_events]
    with open(out_root / "train" / "privacy_log.csv") as fh:
        eps = [float(r["Epsilon"]) for r in csv.DictReader(fh)]
    with open(out_root / "train" / "log.csv") as fh:
        rows = list(csv.DictReader(fh))
    losses = [float(rows[-1][k]) for k in ("G Adv Loss", "D Adv Loss", "D Real Loss",
                                           "D Fake Loss", "D Real Aux Loss")]
    if len(eps) != e or not all(math.isfinite(x) and x > 0 for x in eps):
        fail(f"bad epsilon column {eps}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite losses {losses}")
    state_ok = all(torch.isfinite(t).all() for t in tr.state.d_params.values()) and \
        all(torch.isfinite(t).all() for t in tr.state.g_params.values())
    if not state_ok:
        fail("non-finite params after training")
    samples = tr.n_batches * BS
    rest = ep_ms[1:] or ep_ms
    print(f"main path: {e} epochs x {tr.n_batches} steps in one group, K1 launches "
          f"{launches}; epoch ms first {ep_ms[0]:.3f}, rest mean "
          f"{sum(rest) / len(rest):.3f} ({', '.join(f'{x:.3f}' for x in rest)}); "
          f"{samples * len(rest) / (sum(rest) / 1e3):.0f} samples/s after the first; "
          f"wall {wall:.2f} s; epsilon {eps[-1]:.6f}; losses G {losses[0]:.4f} D {losses[1]:.4f}")

    # 5. Kernel and plain times at the main path's shapes (one full epoch).
    n = TIME_STEPS
    b = builder(True, "time")
    ins = inputs(b, n, True, seed=12)
    pe.epoch_kernel(b, *ins)                        # warm-up
    times = []
    for _ in range(3):
        s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s0.record()
        pe.epoch_kernel(b, *ins)
        s1.record()
        torch.cuda.synchronize()
        times.append(s0.elapsed_time(s1))
    s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s0.record()
    pe.epoch_plain(b, *ins)
    s1.record()
    torch.cuda.synchronize()
    plain_ms = s0.elapsed_time(s1)
    p_d = sum(t.numel() for t in ins[7][:6])
    p_g = sum(t.numel() for t in ins[7][6:])
    flops, nbytes = k1_flops(n), k1_bytes(n, p_d, p_g, True)
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bytes * 1e3
    ms = min(times)
    print(f"K1 epoch of {n} steps: kernel {ms:.3f} ms (runs {', '.join(f'{x:.3f}' for x in times)}), "
          f"plain {plain_ms:.3f} ms, bound {max(t_ops, t_bytes):.3f} ms "
          f"({flops / 1e9:.1f} GFLOP at {peak_flops / 1e12:g} TFLOP/s fp32; "
          f"{nbytes / 1e6:.1f} MB at {peak_bytes / 1e12:g} TB/s)")
    # Device time by CUDA kernel over one K1 epoch (torch.profiler / CUPTI).
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s0.record()
        pe.epoch_kernel(b, *ins)
        s1.record()
        torch.cuda.synchronize()
    span = s0.elapsed_time(s1)
    by_kernel = []
    for ev in prof.key_averages():
        t_dev = getattr(ev, "self_device_time_total", None)
        if t_dev is None:
            t_dev = getattr(ev, "self_cuda_time_total", 0)
        if t_dev > 0:
            by_kernel.append((t_dev / 1e3, ev.count, ev.key[:110]))
    by_kernel.sort(reverse=True)
    busy = sum(r[0] for r in by_kernel)
    print(f"profile: device busy {busy:.3f} ms of a {span:.3f} ms epoch "
          f"({100 * busy / span:.1f}%), by kernel (ms, launches, name):")
    for t_ms, cnt, key in by_kernel[:12]:
        print(f"  {t_ms:9.3f} {cnt:6d}  {key}")
    kernels = [{
        "name": "k1_epoch", "route": "cuda",
        "source": "csl_gan_tpu_torch/ops/csrc/k1_epoch.cu",
        "replaces": "csl_gan_tpu/ops/pallas_epoch.py:184",
        "launches": launches, "max_abs_err": max_abs,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
