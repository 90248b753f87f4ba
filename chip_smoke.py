#!/usr/bin/env python3
"""Smoke run of the PyTorch port (csl_gan_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one NVIDIA H100 and the CUDA
toolkit, it:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds every kernel of the ported paths from the sources (one nvcc per
     source, in parallel) and prints the build time and ptxas report;
  3. MNIST path (K1). Holds K1 against its plain PyTorch version on the
     card, at the path's full width (bs 600, F 784, nc 10, latent 100,
     H 128), with seeded inputs: 5 steps with DP from the initial state, 5
     without DP from a mid-training Adam state, and 5 with DP on an fp32
     table; it also prints, without holding it to the bound, the gap of 5
     steps without DP from zero Adam moments. Then drives the path through
     its entry point, the port's Trainer on ``MNIST --conditional -dpm gc
     --sigma 10 -bs 600 -tss 60000`` (synthetic MNIST) for 2 epochs in one
     group, checks the K1 launch count, finite losses and epsilon, prints
     ms/epoch and samples/s, and times K1 and its plain version on one
     100-step epoch with the device time by CUDA kernel (torch.profiler);
  4. CelebA path (K2-K5). Holds K2/K3 against their plain versions at the
     flagship's ghost-order layers conv2-conv4 and K4/K5 at the generator's
     five norm shapes (B 128, bf16), timing each beside its plain version
     and one PyTorch library call where one computes the same function. K2
     and K3 have two variants: the tensor-core one, which these bf16 layers
     take, is also held at a bf16 geometry with ragged edges, the FFMA one
     at the same layers with fp32 operands (B 8), and the two are timed in
     turns (FFMA, tensor cores, tensor cores, FFMA) per layer with TFLOP/s
     and the share of the bf16 bound, by CUDA events around the wrapper
     calls and by device time (torch.profiler);
     holds one port D step and one G step at full width (bs 8; fp32, and
     bf16 compute) through K2-K5 against the same steps through the plain
     versions, both on the card, and prints two witnesses beside the gap
     (the plain steps repeated, and the plain steps with z moved by 1e-7
     relative); drives
     the path through its entry point, the port's Trainer on ``CelebA
     --conditional -dpm gc -bs 128 -tss 12800 -nms 1 --mean_sample_size 8
     --bf16 true --train_d_until_threshold 1e18`` (synthetic CelebA, full
     celeba_g64 / celeba_d64 width) for 2 epochs, checks that K2-K5 each
     launched (K2 and K3 three times per D step, each time the tensor-core
     variant), finite losses and epsilon, prints ms per D step and samples/s,
     and the device time by CUDA kernel of one more epoch;
  5. materialized per-sample-gradient paths (K6). Holds K6 against its
     plain version (the same Philox stream) at path 1's leaf [600, 101632],
     at every large leaf of celeba_d64 at B 128, at an odd P and at the leaf
     gate's P = 16384: the sum at std 0, sum and noise at std 2.5 with one
     seed, another seed, the same seed twice (bitwise), and the noise's
     moments; times each beside its plain version, ``w @ g`` +
     ``std * torch.randn`` and its bytes bound. Holds the MNIST ghost-clipped
     real sum against the materialized one (bs 600), and one full-width D
     step of each path through K6 against the same step through K6's plain
     version with the same seeds. Then drives, through the Trainer, path 1
     (``MNIST --conditional -dpm gc --sigma 10 -bs 600 --pallas true
     --grad_clip_split false``) and path 2 (``CelebA --conditional -dpm gc
     -bs 128 -tss 1280 -nms 1 --mean_sample_size 8 --bf16 true
     --train_d_until_threshold 1e18 --conv_ghost false --pallas true``) for 2
     epochs each, counts K6's launches, and prints ms per D step beside the
     K1 path's and the conv-ghost path's of the same run, where each step's
     time goes (vmap(grad), norms, K6 and small leaves, the rest) and the
     device time by CUDA kernel of one more epoch;
  6. prints one JSON ``kernels`` line (K1-K6: launches on their main path,
     max abs gap to the plain version, ms, plain ms, bound, library ms);
  7. ends with ``{"ok": true, "device": {...}}`` as the last line.
Any failure raises or exits non-zero, and no result line is printed. It
needs no network and imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import csv
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Published peaks by the name nvidia-smi gives (NVIDIA data sheets, dense):
# fp32 outside the tensor cores, bf16 on the tensor cores, and device memory
# bandwidth, at the full power limit. The first match wins.
PEAKS = (("H100 PCIe", 51.2e12, 756e12, 2.0e12), ("H100 NVL", 60.0e12, 835e12, 3.9e12),
         ("H200", 67.0e12, 989e12, 4.8e12), ("H100", 67.0e12, 989e12, 3.35e12))

BS, F, NC, LATENT, H = 600, 784, 10, 100, 128
EPOCHS, CHECK_STEPS, TIME_STEPS = 2, 5, 100
# Kernel vs plain: both run the same fp32 arithmetic in another reduction
# order (tiled FFMA sums against PyTorch's kernels with TF32 off), so single
# results agree to ~1e-7 relative and, after 5 Adam steps, params and
# moments to a few 1e-6 with DP and ~1e-5 without (H100). 1e-4 leaves room
# for that drift and still fails on any wrong term, which moves a step's
# update by ~lr / |param| ~ 1e-2 relative.
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


# ---------------- the CelebA path (K2-K5) ----------------

CB = 128                                   # the flagship's batch
# The D's ghost-order layers (conv2-conv4): (H of the input, Cin, Cout); 5x5,
# stride 2, pad 2 (models/dcresnet.py celeba_d64).
CONV_LAYERS = ((32, 64, 128), (16, 128, 256), (8, 256, 512))
# The G's norms: (HW, C) and how many of the nine layers have that shape.
GN_SHAPES = ((16, 512, 1), (64, 512, 2), (256, 256, 2), (1024, 128, 2), (4096, 64, 2))
FLAGSHIP = ["CelebA", "--conditional", "-dpm", "gc", "-bs", str(CB), "-tss", "12800",
            "-nms", "1", "--mean_sample_size", "8", "--bf16", "true",
            "--train_d_until_threshold", "1e18"]
CELEBA_EPOCHS = 2
# K2/K3 vs plain: the same bf16 inputs, exact fp32 products, fp32 sums in
# another order (and K3 rounds w * c to bf16 exactly as the plain version
# does), so the gap is reduction order: ~1e-7 to 1e-5 relative with FFMA
# sums and up to ~2e-5 with the tensor cores' fp32 accumulation (H100). A
# wrong term or a dropped tile moves it to >= 1e-3.
CONV_BOUND = 1e-4
# A bf16 geometry whose S, K and O are no multiples of the tensor-core tiles
# (B, H, Cin, Cout; 5x5, stride 2, pad 2), and the batch of the fp32 check.
CONV_RAGGED = (7, 16, 24, 40)
CONV_FP32_BATCH = 8
# K4/K5 vs plain: fp32 statistics in another summation order; the bf16
# outputs (y, dx) then round to the other side of a bf16 step on rare
# elements (one ulp, 2^-8 relative), ~2e-5 in relative l2 (H100). dgamma /
# dbeta are fp32 sums: reduction order only.
GN_BOUND, GN_PARAM_BOUND = 1e-3, 1e-4
# One full-width D step and G step on the card (fp32, TF32 off, deterministic
# cuDNN) through K2-K5 against the same steps through the plain versions; the
# plain steps repeat exactly, so only K2-K5 differ. On an H100 the D step's
# params and moments differ by ~1e-5 (reduction order) and the metrics by
# ~1e-6. G's gradient is far more sensitive: its ReLU masks and D's
# leaky-ReLU masks flip on the few elements within rounding of 0, and moving
# z by 1e-7 relative moves G's moments by ~7e-3, twice the ~4e-3 that K2-K5
# move them by. So G is held to 2e-2, under 3x that witness, which the check
# prints on every run. A fault in the wiring (a layer, a factor, a scale)
# moves them by O(1).
STEP_BOUND_D, STEP_BOUND_G, STEP_BOUND_MET = 1e-4, 2e-2, 1e-4


# ---------------- the materialized paths (K6) ----------------

PATH1 = ["MNIST", "--conditional", "-dpm", "gc", "--sigma", "10", "-bs", str(BS),
         "-tss", "60000", "--pallas", "true", "--grad_clip_split", "false"]
PATH2 = ["CelebA", "--conditional", "-dpm", "gc", "-bs", str(CB), "-tss", "1280",
         "-nms", "1", "--mean_sample_size", "8", "--bf16", "true",
         "--train_d_until_threshold", "1e18", "--conv_ghost", "false", "--pallas", "true"]
K6_EPOCHS = 2
K6_STD = 2.5
# K6 vs plain. The sum: the same fp32 products added in another order (K6:
# ascending rows per split, then the splits; plain: cuBLAS), ~1e-7 relative
# (H100). The noise: both compute the same Philox words exactly and the same
# Box-Muller in fp32, whose logf / cosf may differ by an ulp between the two
# compilers' math libraries: ~1e-6 * std. So with one seed the results are
# held to 1e-4 * std absolute (the sum's gap included: inputs are N(0, 1)
# rows and weights in [0.1, 1]), which a wrong counter, key or uniform (an
# independent draw, gap ~ std) fails by four orders of magnitude.
K6_SUM_BOUND, K6_NOISE_BOUND = 1e-5, 1e-4
# One full-width D step through K6 against the same step through K6's plain
# version, same seeds (deterministic cuDNN): only the sum's order differs, so
# D's params and moments are held like the CelebA step check's; the metrics
# are taken before the update and must not move at all beyond that bound.
K6_STEP_BOUND = 1e-4
# The ghost-clipped real sum against the materialized one (fp32, TF32 off):
# analytic norms and matrix products against vmap(grad) and K6's sum.
GHOST_BOUND = 1e-4

# CUDA kernel names by group, for the step profiles; the first match wins.
PROFILE_GROUPS = (
    ("K6 clip_noise", ("wsum_partial", "sum_noise")),
    ("K2 ghost_sq_norms", ("ghost_norm_tc", "ghost_norm_tiles", "sum_rows")),
    ("K3 weighted_kernel_grad", ("wsum_tc", "scale_cotangent", "wsum_tiles", "sum_splits")),
    ("K4/K5 gn_relu", ("gn_channel_sums", "gn_relu_apply", "gn_bwd_", "gn_param_grads")),
    ("cuDNN convolutions", ("implicit_gemm", "cudnn", "fprop", "dgrad", "wgrad")),
    ("cuBLAS GEMMs", ("gemm", "gemv")),
    ("im2col (conv1's direct order)", ("im2col",)),
    ("copies and casts", ("copy",)),
    ("reductions", ("reduce_kernel",)),
    ("other element-wise", ("elementwise",)),
)


def device_ms_by_kernel(prof):
    """[(device ms, launches, name)] of each CUDA kernel in a torch.profiler
    run, largest first (operator rows, which repeat their kernels' time, are
    left out)."""
    rows = []
    for ev in prof.key_averages():
        if "CUDA" not in str(ev.device_type):
            continue
        t_dev = getattr(ev, "self_device_time_total", None)
        if t_dev is None:
            t_dev = getattr(ev, "self_cuda_time_total", 0)
        if t_dev > 0:
            rows.append((t_dev / 1e3, ev.count, ev.key[:110]))
    return sorted(rows, reverse=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps launches, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s0.record()
    for _ in range(reps):
        fn()
    s1.record()
    torch.cuda.synchronize()
    return s0.elapsed_time(s1) / reps


def device_ms(fn, reps: int):
    """Device time of fn by CUDA kernel over reps calls (torch.profiler /
    CUPTI): (sum of the kernels' ms per call, {kernel name: ms per call})."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):              # a trace now and then comes back empty
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = device_ms_by_kernel(prof)
        if rows and all(cnt % reps == 0 for _, cnt, _ in rows):
            by = {key: t / reps for t, _, key in rows}
            return sum(by.values()), by
    fail("torch.profiler recorded no complete device trace in 5 tries")


def ptxas_by_kernel(log: str):
    """{demangled-enough kernel name: "N registers, ... spill ..."} from a
    ptxas -v report."""
    out, name, frame = {}, None, ""
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "bytes stack frame" in line:
            frame = line
        elif line.startswith("ptxas info") and "Used" in line and name:
            out[name] = f"{line.split(':', 1)[1].strip()}; {frame}"
            name = None
    return out


def bound(ops: float, nbytes: float, peak_ops: float, peak_bytes: float):
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / peak_bytes * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def k2_ops(b: int, s: int, k: int, o: int) -> float:
    """Operations that B per-sample norms ||U_i^T C_i||^2 need at least: the
    cheaper of the symmetric half of both [S, S] Grams with their Frobenius
    product, and the direct order (each [K, O] product, then its squares)."""
    grams = float(b) * s * (s + 1) * (k + o + 1)
    direct = 2.0 * b * k * o * (s + 1)
    return min(grams, direct)


def conv_ghost_phase(dev, peak_bf16, peak_bytes):
    """K2 / K3 against their plain versions: the tensor-core variant at
    conv2-conv4 (bf16, B 128) and at a ragged bf16 geometry, the FFMA variant
    at conv2-conv4 with fp32 operands; then both variants timed in turns."""
    import torch
    from csl_gan_tpu_torch.ops import pallas_conv_ghost as pcg

    g = torch.Generator(dev).manual_seed(21)

    def operands(b, h, cin, cout, dtype):
        ho = (h + 4 - 5) // 2 + 1
        a = torch.randn(b, h, h, cin, generator=g, device=dev).to(dtype)
        c = torch.randn(b, ho, ho, cout, generator=g, device=dev).to(dtype)
        w = torch.rand(b, generator=g, device=dev) * 0.9 + 0.1
        return a, c, w, (5, 5, cin, cout)

    def held(tag, a, c, w, ks, want):
        """Both kernels against plain; the variant they took must be `want`."""
        before = (pcg.ghost_sq_norms.launches_tc, pcg.weighted_kernel_grad.launches_tc)
        nk, npl = pcg.ghost_sq_norms(a, c, 5, 5, 2, 2), pcg.ghost_sq_norms_plain(a, c, 5, 5, 2, 2)
        wk = pcg.weighted_kernel_grad(a, c, w, ks, 2, 2)
        wp = pcg.weighted_kernel_grad_plain(a, c, w, ks, 2, 2)
        torch.cuda.synchronize()
        took = (pcg.ghost_sq_norms.launches_tc - before[0],
                pcg.weighted_kernel_grad.launches_tc - before[1])
        r2, r3 = rel_l2(nk, npl), rel_l2(wk, wp)
        if took != ((1, 1) if want == "tc" else (0, 0)):
            fail(f"K2/K3 did not take the {want} variant at {tag}")
        if not (r2 < CONV_BOUND and r3 < CONV_BOUND):
            fail(f"K2/K3 ({want}) disagree with their plain versions at {tag}: "
                 f"rel l2 {r2:.3e}, {r3:.3e}")
        return r2, r3, float((nk - npl).abs().max()), float((wk - wp).abs().max())

    b, h, cin, cout = CONV_RAGGED
    r2, r3, _, _ = held("the ragged geometry", *operands(b, h, cin, cout, torch.bfloat16), "tc")
    print(f"conv ragged [{b}, {h}, {h}, {cin}]->{cout} bf16, tensor cores: K2 rel l2 {r2:.3e}, "
          f"K3 rel l2 {r3:.3e} (bound {CONV_BOUND:g})")
    for h, cin, cout in CONV_LAYERS:
        r2, r3, _, _ = held(f"fp32 conv {h}x{h}x{cin}->{cout}",
                            *operands(CONV_FP32_BATCH, h, cin, cout, torch.float32), "ffma")
        print(f"conv {h}x{h}x{cin}->{cout} fp32 (B {CONV_FP32_BATCH}), FFMA: K2 rel l2 {r2:.3e}, "
              f"K3 rel l2 {r3:.3e} (bound {CONV_BOUND:g})")

    keys = ("k2", "k2_ffma", "k2_dev", "k2_plain", "k3", "k3_ffma", "k3_dev", "k3_pre_dev",
            "k3_plain", "k3_lib", "k3_lib_dev", "k2_ops", "k2_bytes", "k3_ops", "k3_bytes")
    tot = {k: 0.0 for k in keys}
    err = {"k2": 0.0, "k3": 0.0}
    for h, cin, cout in CONV_LAYERS:
        ho = h // 2
        a, c, w, ks = operands(CB, h, cin, cout, torch.bfloat16)
        r2, r3, e2, e3 = held(f"conv {h}x{h}x{cin}->{cout}", a, c, w, ks, "tc")
        err["k2"], err["k3"] = max(err["k2"], e2), max(err["k3"], e3)
        # Library yardstick of K3: cuDNN's weight gradient of the conv on the
        # w-scaled bf16 cotangent (the scaling is not timed).
        a_nchw = a.permute(0, 3, 1, 2)
        cw = (c.float() * w[:, None, None, None]).to(torch.bfloat16).permute(0, 3, 1, 2)
        wshape = (cout, cin, 5, 5)
        k2 = lambda v: (lambda: pcg.ghost_sq_norms(a, c, 5, 5, 2, 2, variant=v))  # noqa: E731
        k3 = lambda v: (lambda: pcg.weighted_kernel_grad(a, c, w, ks, 2, 2, variant=v))  # noqa: E731
        lib = lambda: torch.nn.grad.conv2d_weight(a_nchw, wshape, cw, 2, 2)  # noqa: E731
        # In turns within this call: FFMA, tensor cores, tensor cores, FFMA.
        turns = {key: [cuda_ms(fn(v), 10) for v in ("ffma", "tc", "tc", "ffma")]
                 for key, fn in (("k2", k2), ("k3", k3))}
        t = {"k2": sum(turns["k2"][1:3]) / 2, "k2_ffma": (turns["k2"][0] + turns["k2"][3]) / 2,
             "k3": sum(turns["k3"][1:3]) / 2, "k3_ffma": (turns["k3"][0] + turns["k3"][3]) / 2,
             "k2_plain": cuda_ms(lambda: pcg.ghost_sq_norms_plain(a, c, 5, 5, 2, 2), 5),
             "k3_plain": cuda_ms(lambda: pcg.weighted_kernel_grad_plain(a, c, w, ks, 2, 2), 5),
             "k3_lib": cuda_ms(lib, 10)}
        t["k2_dev"], _ = device_ms(k2("tc"), 10)
        t["k3_dev"], by3 = device_ms(k3("tc"), 10)
        t["k3_pre_dev"] = sum(v for k, v in by3.items() if "scale_cotangent" in k)
        t["k3_lib_dev"], _ = device_ms(lib, 10)
        s, k = ho * ho, 25 * cin
        in_bytes = (a.numel() + c.numel()) * 2
        t.update(k2_ops=k2_ops(CB, s, k, cout), k2_bytes=in_bytes + CB * 4,
                 k3_ops=2.0 * CB * s * k * cout, k3_bytes=in_bytes + CB * 4 + k * cout * 4)
        for key, v in t.items():
            tot[key] += v
        rate = lambda ops, ms: (f"{ops / ms / 1e9:.1f} TFLOP/s, "  # noqa: E731
                                f"{100 * ops / peak_bf16 * 1e3 / ms:.1f}% of the bf16 bound")
        print(f"conv {h}x{h}x{cin}->{cout} bf16 (B {CB}), tensor cores: K2 rel l2 {r2:.3e}, K3 rel "
              f"l2 {r3:.3e} (bound {CONV_BOUND:g})")
        print(f"  K2 ms by CUDA events, in turns FFMA/tc/tc/FFMA: "
              f"{', '.join(f'{x:.4f}' for x in turns['k2'])}; tensor cores {t['k2']:.4f} "
              f"(device {t['k2_dev']:.4f}: {rate(t['k2_ops'], t['k2_dev'])}), FFMA "
              f"{t['k2_ffma']:.4f}, plain {t['k2_plain']:.3f}")
        print(f"  K3 ms by CUDA events, in turns FFMA/tc/tc/FFMA: "
              f"{', '.join(f'{x:.4f}' for x in turns['k3'])}; tensor cores {t['k3']:.4f} "
              f"(device {t['k3_dev']:.4f}, the pre-pass {t['k3_pre_dev']:.4f} of it: "
              f"{rate(t['k3_ops'], t['k3_dev'])}), FFMA {t['k3_ffma']:.4f}, plain "
              f"{t['k3_plain']:.3f}, conv2d_weight {t['k3_lib']:.4f} (device {t['k3_lib_dev']:.4f})")
        del a, c, a_nchw, cw
    b2, by2 = bound(tot["k2_ops"], tot["k2_bytes"], peak_bf16, peak_bytes)
    b3, by3 = bound(tot["k3_ops"], tot["k3_bytes"], peak_bf16, peak_bytes)
    per = "D step (conv2 + conv3 + conv4)"
    print(f"K2 / K3 per {per}, ms: K2 tensor cores {tot['k2']:.4f} by CUDA events, "
          f"{tot['k2_dev']:.4f} on the device (bound {b2:.4f}, {by2}), FFMA {tot['k2_ffma']:.4f}; "
          f"K3 tensor cores {tot['k3']:.4f} by CUDA events, {tot['k3_dev']:.4f} on the device "
          f"(pre-pass {tot['k3_pre_dev']:.4f} of it; bound {b3:.4f}, {by3}), FFMA "
          f"{tot['k3_ffma']:.4f}, conv2d_weight {tot['k3_lib']:.4f} by CUDA events, "
          f"{tot['k3_lib_dev']:.4f} on the device")
    return [
        {"name": "ghost_sq_norms", "route": "cuda",
         "source": "csl_gan_tpu_torch/ops/csrc/conv_ghost.cu",
         "replaces": "csl_gan_tpu/ops/pallas_conv_ghost.py:170",
         "max_abs_err": err["k2"], "ms": tot["k2"], "plain_ms": tot["k2_plain"],
         "bound_ms": b2, "bound_by": by2, "library_ms": None, "per": per,
         "variant": "tc", "device_ms": tot["k2_dev"], "ffma_ms": tot["k2_ffma"]},
        {"name": "weighted_kernel_grad", "route": "cuda",
         "source": "csl_gan_tpu_torch/ops/csrc/conv_ghost.cu",
         "replaces": "csl_gan_tpu/ops/pallas_conv_ghost.py:234",
         "max_abs_err": err["k3"], "ms": tot["k3"], "plain_ms": tot["k3_plain"],
         "bound_ms": b3, "bound_by": by3, "library_ms": tot["k3_lib"], "per": per,
         "variant": "tc", "device_ms": tot["k3_dev"], "ffma_ms": tot["k3_ffma"],
         "library_device_ms": tot["k3_lib_dev"]}]


def groupnorm_phase(dev, peak_bytes):
    """K4 / K5 against their plain versions and timed, at the G's norms."""
    import torch
    import torch.nn.functional as fn
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn

    g = torch.Generator(dev).manual_seed(22)
    tot = {k: 0.0 for k in ("k4", "k4_plain", "k4_lib", "k5", "k5_plain",
                            "k4_bytes", "k5_bytes")}
    err = {"k4": 0.0, "k5": 0.0}
    for hw, c, mult in GN_SHAPES:
        x = (torch.randn(CB, hw, c, generator=g, device=dev) * 2 + 0.3).to(torch.bfloat16)
        dy = torch.randn(CB, hw, c, generator=g, device=dev).to(torch.bfloat16)
        sc = torch.randn(c, generator=g, device=dev) * 0.2 + 1.0
        bi = torch.randn(c, generator=g, device=dev) * 0.1
        yk, yp = gn.gn_relu_forward(x, sc, bi, 32, 1e-5), gn.gn_relu_plain(x, sc, bi, 32, 1e-5)
        bk = gn.gn_relu_backward(x, dy, sc, bi, 32, 1e-5)
        bp = gn.gn_relu_bwd_plain(x, dy, sc, bi, 32, 1e-5)
        torch.cuda.synchronize()
        r4 = rel_l2(yk.float(), yp.float())
        r5 = rel_l2(bk[0].float(), bp[0].float())
        rp = max(rel_l2(bk[1], bp[1]), rel_l2(bk[2], bp[2]))
        err["k4"] = max(err["k4"], float((yk.float() - yp.float()).abs().max()))
        err["k5"] = max(err["k5"], max(float((u.float() - v.float()).abs().max())
                                       for u, v in zip(bk, bp)))
        # Library yardstick of K4: F.group_norm then relu on an NCHW copy
        # (bf16 affine; the copy is not timed).
        xc = x.transpose(1, 2).contiguous()
        scb, bib = sc.to(torch.bfloat16), bi.to(torch.bfloat16)
        t = {"k4": cuda_ms(lambda: gn.gn_relu_forward(x, sc, bi, 32, 1e-5), 20),
             "k4_plain": cuda_ms(lambda: gn.gn_relu_plain(x, sc, bi, 32, 1e-5), 5),
             "k4_lib": cuda_ms(lambda: fn.relu(fn.group_norm(xc, 32, scb, bib, 1e-5)), 20),
             "k5": cuda_ms(lambda: gn.gn_relu_backward(x, dy, sc, bi, 32, 1e-5), 20),
             "k5_plain": cuda_ms(lambda: gn.gn_relu_bwd_plain(x, dy, sc, bi, 32, 1e-5), 5),
             "k4_bytes": 2 * x.numel() * 2 + 2 * c * 4,
             "k5_bytes": 3 * x.numel() * 2 + 4 * c * 4}
        for key, v in t.items():
            tot[key] += mult * v
        print(f"groupnorm+relu [{CB}, {hw}, {c}] x{mult}: K4 rel l2 {r4:.3e}, K5 dx rel l2 "
              f"{r5:.3e} (bound {GN_BOUND:g}), dgamma/dbeta {rp:.3e} (bound {GN_PARAM_BOUND:g}); "
              f"K4 {t['k4']:.3f} ms (plain {t['k4_plain']:.3f}, group_norm+relu "
              f"{t['k4_lib']:.3f}), K5 {t['k5']:.3f} ms (plain {t['k5_plain']:.3f})")
        if not (r4 < GN_BOUND and r5 < GN_BOUND and rp < GN_PARAM_BOUND):
            fail(f"K4/K5 disagree with their plain versions at [{CB}, {hw}, {c}]")
        del x, dy, xc, yk, yp, bk, bp
    # Element-wise arithmetic (~10 flop per element) is far below the bytes.
    b4, by4 = bound(0.0, tot["k4_bytes"], 1.0, peak_bytes)
    b5, by5 = bound(0.0, tot["k5_bytes"], 1.0, peak_bytes)
    return [
        {"name": "gn_relu_forward", "route": "cuda",
         "source": "csl_gan_tpu_torch/ops/csrc/gn_relu.cu",
         "replaces": "csl_gan_tpu/ops/pallas_groupnorm.py:111",
         "max_abs_err": err["k4"], "ms": tot["k4"], "plain_ms": tot["k4_plain"],
         "bound_ms": b4, "bound_by": by4, "library_ms": tot["k4_lib"],
         "per": "G forward (nine norms)"},
        {"name": "gn_relu_backward", "route": "cuda",
         "source": "csl_gan_tpu_torch/ops/csrc/gn_relu.cu",
         "replaces": "csl_gan_tpu/ops/pallas_groupnorm.py:119",
         "max_abs_err": err["k5"], "ms": tot["k5"], "plain_ms": tot["k5_plain"],
         "bound_ms": b5, "bound_by": by5, "library_ms": None,
         "per": "G backward (nine norms)"}]


@contextlib.contextmanager
def _swapped(swaps):
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def plain_versions(groupnorm=True):
    """K2-K5's wrappers (K2/K3's only with groupnorm=False) replaced by their
    plain versions, so that a step on the card runs the same cuDNN
    convolutions without the kernels."""
    from csl_gan_tpu_torch.ops import pallas_conv_ghost as pcg
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn
    swaps = ((pcg, "ghost_sq_norms", pcg.ghost_sq_norms_plain),
             (pcg, "weighted_kernel_grad", pcg.weighted_kernel_grad_plain),
             (gn, "gn_relu_forward", gn.gn_relu_plain),
             (gn, "gn_relu_backward", gn.gn_relu_bwd_plain))
    return _swapped(swaps if groupnorm else swaps[:2])


def plain_clip():
    """K6's wrapper replaced by its plain version (and nothing else: the G
    forward of the step goes on through K4 on both sides)."""
    from csl_gan_tpu_torch.ops import pallas_clip as pc

    def clip_plain(g, w, seed, std):
        return pc.weighted_sum_noise_plain(g.reshape(g.shape[0], -1), w, seed,
                                           std).reshape(g.shape[1:])

    return _swapped(((pc, "leaf_weighted_sum_noise", clip_plain),))


def celeba_step_check(dev, out_root, bf16=False):
    """One full-width D step and one G step (bs 8; fp32 with TF32 off, or
    bf16 compute, where K2/K3 take their tensor-core variant; deterministic
    cuDNN), each from the initial state, on the card: through
    K2-K5 against the same steps through the plain versions. Two witnesses
    beside the gap: the plain steps run twice (cuDNN repeats exactly, so K2-K5
    are the only difference), and the plain steps with z moved by 1e-7
    relative (how far a perturbation the size of K4's reduction-order gap
    moves the steps). Under bf16 the reference swaps K2/K3 only: K4/K5's bf16
    outputs differ from their plain versions' by single-ulp roundings (2^-8
    relative on rare elements, GN_BOUND), which the bf16 step amplifies to
    ~3e-2 on D's moments and ~8e-2 on G's (H100; printed beside the gap, not
    held), and a z moved by 1e-7 rounds back to the same bf16 value. K4/K5
    are held in the step by the fp32 check."""
    import numpy as np
    import torch
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.models.registry import init_models
    from csl_gan_tpu_torch.training.steps import StepBuilder

    bs = 8
    argv = ["CelebA", "--conditional", "-dpm", "gc", "-bs", str(bs), "-tss", "12800",
            "-nms", "1", "--mean_sample_size", "8", "--sigma", "0", "-c", "1",
            "--train_d_until_threshold", "1e18", "--manual_seed", "1", "--platform", "gpu",
            "-o", str(out_root / ("celeba_step_bf16" if bf16 else "celeba_step"))]
    argv += ["--bf16", "true"] if bf16 else []
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (bs, 64, 64, 3)).astype(np.float32)
    y = rng.integers(0, 2, bs)
    z, zg = (rng.standard_normal((bs, 128)).astype(np.float32) for _ in range(2))
    yg = rng.integers(0, 2, bs)
    pen_x = rng.uniform(-1, 1, (bs, 64, 64, 3)).astype(np.float32)
    alpha = rng.uniform(0, 1, (bs, 1, 1, 1)).astype(np.float32)
    nudge = [1 + 1e-7 * rng.standard_normal(v.shape).astype(np.float32) for v in (z, zg)]
    opt = toptions.parse(argv)
    G, D = init_models(opt, dev)
    b = StepBuilder(opt, G, D)
    assert b.use_conv_ghost
    st0 = b.init_state()
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    noise = [torch.zeros_like(st0.d_params[k]) for k in b.d_leaves]

    def steps(zd, zgen):
        st_d, dm = b.d_step_conv_ghost(st0, t(x), t(y), t(zd), noise, t(pen_x), t(y),
                                       [t(alpha)])
        # The G step starts from the initial D too: after a first Adam step
        # (b1 0) each D param has moved by lr times the sign of its gradient,
        # so a D gradient component within rounding of 0 would flip there.
        st_g, gm = b.g_step_dcresnet(st0, t(zgen), t(yg))
        torch.cuda.synchronize()
        return st_d, st_g, dm, gm

    cudnn = torch.backends.cudnn
    was = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    from csl_gan_tpu_torch.ops import pallas_conv_ghost as pcg
    tc_before = pcg.ghost_sq_norms.launches_tc + pcg.weighted_kernel_grad.launches_tc
    try:
        kern = steps(z, zg)
        took_tc = pcg.ghost_sq_norms.launches_tc + pcg.weighted_kernel_grad.launches_tc - tc_before
        with plain_versions(groupnorm=not bf16):
            plain = steps(z, zg)
            again = steps(z, zg)
            nudged = steps(z * nudge[0], zg * nudge[1])
        if bf16:
            with plain_versions():
                all_plain = steps(z, zg)
    finally:
        cudnn.deterministic, cudnn.benchmark = was

    # Each group as one vector: D params and moments after the D step, G
    # moments (the gradient and 0.1 x its square; b1 0, b2 0.9) after the G
    # step. G params are left out: the first Adam step moves each by +-lr,
    # and those of G's GroupNorm biases start at 0.
    def gaps(one, ref):
        (d1, g1, dm1, gm1), (d0, g0, dm0, gm0) = one, ref
        out = {}
        for group, u, v in (("D params", d1.d_params, d0.d_params), ("D mu", d1.d_mu, d0.d_mu),
                            ("D nu", d1.d_nu, d0.d_nu), ("G mu", g1.g_mu, g0.g_mu),
                            ("G nu", g1.g_nu, g0.g_nu)):
            out[group] = rel_l2(torch.cat([u[k].reshape(-1) for k in v]),
                                torch.cat([v[k].reshape(-1) for k in v]))
        # Accuracies and clipped shares count samples: left out.
        counts = ("d_real_acc", "d_fake_acc", "d_real_aux_acc", "frac_clipped", "g_aux_acc")
        out["metrics"] = max(
            float((m1[k] - m0[k]).abs().max() / max(float(m0[k].abs().max()), 1e-2))
            for m1, m0 in ((dm1, dm0), (gm1, gm0)) for k in m1 if k not in counts)
        return out

    fmt = lambda r: ", ".join(f"{k} {v:.3e}" for k, v in r.items())  # noqa: E731
    gap, rep, wit = gaps(kern, plain), gaps(again, plain), gaps(nudged, plain)
    print(f"CelebA D step and G step (bs {bs}, {'bf16' if bf16 else 'fp32'}, full width) on the "
          f"card, {'K2/K3' if bf16 else 'K2-K5'} vs plain: rel l2 {fmt(gap)} (bounds D "
          f"{STEP_BOUND_D:g}, G "
          f"{STEP_BOUND_G:g}, metrics {STEP_BOUND_MET:g}); clipped "
          f"{float(kern[2]['frac_clipped'].mean()):.2f}; K2 + K3 launches on the tensor cores "
          f"{took_tc}")
    if took_tc != (2 * len(CONV_LAYERS) if bf16 else 0):
        fail(f"K2/K3 took the tensor-core variant {took_tc} times in the "
             f"{'bf16' if bf16 else 'fp32'} step")
    print(f"  witnesses: plain repeated {fmt(rep)}; plain with z moved 1e-7 {fmt(wit)}")
    if bf16:
        print(f"  printed only: K4/K5 too replaced by their plain versions, against that "
              f"reference {fmt(gaps(all_plain, plain))}")
    d_gap = max(v for k, v in gap.items() if k.startswith("D"))
    g_gap = max(v for k, v in gap.items() if k.startswith("G"))
    if max(rep.values()) != 0.0:
        fail("the plain CelebA steps do not repeat exactly on the card")
    if not (d_gap < STEP_BOUND_D and g_gap < STEP_BOUND_G and gap["metrics"] < STEP_BOUND_MET):
        fail(f"the CelebA steps ({'bf16' if bf16 else 'fp32'}) through the kernels disagree "
             f"with the plain steps on the card")


def profile_step_runner(tr, label: str) -> None:
    """Device time by CUDA kernel and by group over one more epoch of a
    Trainer on the step runner (torch.profiler / CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    n = tr.n_batches
    s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s0.record()
        tr.state, *_ = tr.runner.run(tr.state, tr.gen_perm, tr.gen, 1)
        s1.record()
        torch.cuda.synchronize()
    span = s0.elapsed_time(s1)
    by_kernel = device_ms_by_kernel(prof)
    busy = sum(r[0] for r in by_kernel)
    print(f"{label} profile: device busy {busy:.3f} ms of a {span:.3f} ms epoch "
          f"({100 * busy / span:.1f}%), by kernel (ms, launches, name):")
    for t_ms, cnt, key in by_kernel[:25]:
        print(f"  {t_ms:9.3f} {cnt:6d}  {key}")
    groups = {}
    for t_ms, _, key in by_kernel:
        g = next((name for name, keys in PROFILE_GROUPS if any(k in key for k in keys)),
                 "other")
        groups[g] = groups.get(g, 0.0) + t_ms
    print(f"{label} profile by group (ms per D step, share of device busy): " + "; ".join(
        f"{g} {t / n:.3f} ({100 * t / busy:.1f}%)"
        for g, t in sorted(groups.items(), key=lambda kv: -kv[1])))


def celeba_phases(dev, out_root, peak_bf16, peak_bytes):
    """The kernel checks, then the CelebA flagship through the Trainer.
    Returns the kernels-line entries of K2-K5 and the path's ms per D step."""
    import csv
    import torch
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.ops import pallas_conv_ghost as pcg
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn
    from csl_gan_tpu_torch.training.loop import Trainer

    entries = conv_ghost_phase(dev, peak_bf16, peak_bytes)
    entries += groupnorm_phase(dev, peak_bytes)
    celeba_step_check(dev, out_root)
    celeba_step_check(dev, out_root, bf16=True)

    e = CELEBA_EPOCHS
    opt = toptions.parse(FLAGSHIP + ["-ne", str(e), "--log_every", str(12800 * e),
                                     "--manual_seed", "1", "-o", str(out_root / "celeba")])
    tr = Trainer(opt)
    wrappers = (pcg.ghost_sq_norms, pcg.weighted_kernel_grad, gn.gn_relu_forward,
                gn.gn_relu_backward)
    for w in wrappers:
        w.launches = 0
    pcg.ghost_sq_norms.launches_tc = pcg.weighted_kernel_grad.launches_tc = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [w.launches for w in wrappers]
    if not all(n > 0 for n in launches):
        fail(f"a CelebA-path kernel never launched: K2-K5 launches {launches}")
    n = tr.n_batches
    launches_tc = [pcg.ghost_sq_norms.launches_tc, pcg.weighted_kernel_grad.launches_tc]
    if launches[:2] != launches_tc or launches_tc != [len(CONV_LAYERS) * e * n] * 2:
        fail(f"K2/K3 launched {launches[:2]} times on the flagship, {launches_tc} of them "
             f"on the tensor cores; expected {len(CONV_LAYERS)} per D step, all tensor-core")
    ep_ms = [a.elapsed_time(b) for a, b in tr.runner.epoch_events]
    with open(out_root / "celeba" / "privacy_log.csv") as fh:
        eps = [float(r["Epsilon"]) for r in csv.DictReader(fh)]
    with open(out_root / "celeba" / "log.csv") as fh:
        row = list(csv.DictReader(fh))[-1]
    losses = [float(row[k]) for k in ("G Adv Loss", "G Aux Loss", "D Adv Loss",
                                      "D Real Loss", "D Fake Loss", "D Real Aux Loss",
                                      "D Penalty")]
    if len(eps) != e or not all(math.isfinite(x) and x > 0 for x in eps):
        fail(f"bad epsilon column {eps}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite CelebA losses {losses}")
    if not all(torch.isfinite(t).all() for p in (tr.state.d_params, tr.state.g_params)
               for t in p.values()):
        fail("non-finite params after CelebA training")
    if tr.state.d_count != e * n or tr.state.g_count != e * -(-n // opt.n_d_steps):
        fail(f"D / G update counts {tr.state.d_count} / {tr.state.g_count} after {e} "
             f"epochs of {n} steps")
    with torch.no_grad():
        img = tr.builder.fakes(tr.state.g_params, tr.builder.gen_z(tr.gen, 4),
                               tr.builder.gen_y(tr.gen, 4))
    if tuple(img.shape) != (4, 64, 64, 3) or not bool((img.abs() <= 1).all()):
        fail(f"bad generator output {tuple(img.shape)}")
    rest = ep_ms[1:] or ep_ms
    step_ms = sum(rest) / len(rest) / n
    print(f"CelebA path: {e} epochs x {n} D steps ({tr.state.g_count} G updates), K2-K5 "
          f"launches {launches} (K2 / K3 on the tensor cores {launches_tc}); ms per D step first epoch {ep_ms[0] / n:.3f}, after "
          f"{step_ms:.3f} (epochs {', '.join(f'{x:.1f}' for x in ep_ms)} ms); "
          f"{CB * 1e3 / step_ms:.0f} samples/s after the first; wall {wall:.2f} s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; epsilon "
          f"{eps[-1]:.6f} (mean samples {tr.mean_sample_privacy_cost:.6f}); losses "
          + ", ".join(f"{x:.4f}" for x in losses))

    profile_step_runner(tr, "CelebA")
    for entry, count in zip(entries, launches):
        entry["launches"] = count
    return entries, step_ms


def _step_builder(argv, dev, out_dir):
    """(opt, StepBuilder) of a config on the card, as the Trainer builds them."""
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.models.registry import init_models
    from csl_gan_tpu_torch.training.steps import StepBuilder

    opt = toptions.parse(argv + ["--manual_seed", "1", "--platform", "gpu", "-o", str(out_dir)])
    G, D = init_models(opt, dev)
    return opt, StepBuilder(opt, G, D)


def clip_kernel_phase(dev, peak_bytes, large_leaves):
    """K6 against its plain version and timed: at path 1's leaf, at every
    large leaf of celeba_d64 (B 128), at an odd P and at the gate's P.
    Returns the kernels-line entry (without its launch counts)."""
    import torch
    from csl_gan_tpu_torch.ops import pallas_clip as pc

    g = torch.Generator(dev).manual_seed(23)
    path2 = sorted({n for _, n in large_leaves})
    shapes = [(BS, (F + NC) * H, "path 1")] + [(CB, n, "path 2") for n in path2]
    shapes += [(CB, n, "extra") for n in (33300, pc.MIN_PALLAS_ELEMS) if n not in path2]
    std = torch.tensor(K6_STD, device=dev)
    zero = torch.tensor(0.0, device=dev)
    rows, err = {}, 0.0
    for b, p, tag in shapes:
        x = torch.randn(b, p, generator=g, device=dev)
        w = torch.rand(b, generator=g, device=dev) * 0.9 + 0.1
        seed = torch.randint(0, 2 ** 63 - 1, (), generator=g, device=dev)
        k0, p0 = pc.leaf_weighted_sum_noise(x, w, seed, zero), \
            pc.weighted_sum_noise_plain(x, w, seed, zero)
        k1, p1 = pc.leaf_weighted_sum_noise(x, w, seed, std), \
            pc.weighted_sum_noise_plain(x, w, seed, std)
        again = pc.leaf_weighted_sum_noise(x, w, seed, std)
        other = pc.leaf_weighted_sum_noise(x, w, seed + 1, std)
        torch.cuda.synchronize()
        r0 = rel_l2(k0, p0)
        gap = float((k1 - p1).abs().max())
        err = max(err, gap, float((k0 - p0).abs().max()))
        z = (k1 - k0) / K6_STD
        mean, sd = float(z.mean()), float(z.std())
        t = {"ms": cuda_ms(lambda: pc.leaf_weighted_sum_noise(x, w, seed, std), 20),
             "plain_ms": cuda_ms(lambda: pc.weighted_sum_noise_plain(x, w, seed, std), 3),
             "library_ms": cuda_ms(lambda: w @ x + std * torch.randn(p, device=dev), 20),
             "bytes": 4.0 * (b * p + b + p) + 12}
        t["bound_ms"] = t["bytes"] / peak_bytes * 1e3
        rows[(b, p)] = (tag, t)
        print(f"K6 [{b}, {p}] ({tag}): std 0 rel l2 {r0:.3e} (bound {K6_SUM_BOUND:g}); std "
              f"{K6_STD} same seed max abs gap {gap:.3e} (bound {K6_NOISE_BOUND * K6_STD:g}); "
              f"noise mean {mean:+.4f} std {sd:.4f}; K6 {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f}, w @ g + randn {t['library_ms']:.4f}, bound "
              f"{t['bound_ms']:.4f} ({100 * t['bound_ms'] / t['ms']:.1f}% of the memory rate)")
        if not (r0 <= K6_SUM_BOUND and gap <= K6_NOISE_BOUND * K6_STD):
            fail(f"K6 disagrees with its plain version at [{b}, {p}]")
        if not torch.equal(k1, again):
            fail(f"K6 is not bitwise reproducible at [{b}, {p}]")
        if not float((k1 - other).abs().max()) > 0.1 * K6_STD:
            fail(f"K6's noise does not depend on the seed at [{b}, {p}]")
        if p >= 1 << 17 and not (abs(mean) < 0.05 and abs(sd - 1.0) < 0.02):
            fail(f"K6's noise moments are off at [{b}, {p}]: mean {mean}, std {sd}")
        del x, k0, p0, k1, p1, again, other, z
    one = rows[(BS, (F + NC) * H)][1]
    two = {key: sum(rows[(CB, n)][1][key] for _, n in large_leaves)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    print("K6 over celeba_d64's large leaves (one D step of path 2): "
          + ", ".join(f"{k} {v:.4f}" for k, v in two.items()))
    return {"name": "leaf_weighted_sum_noise", "route": "cuda",
            "source": "csl_gan_tpu_torch/ops/csrc/clip_noise.cu",
            "replaces": "csl_gan_tpu/ops/pallas_clip.py:61",
            "max_abs_err": err, "ms": one["ms"], "plain_ms": one["plain_ms"],
            "bound_ms": one["bound_ms"], "bound_by": "bytes", "library_ms": one["library_ms"],
            "per": f"launch at path 1's leaf [{BS}, {(F + NC) * H}] (one per D step)",
            "path2": dict(two, per=f"D step: {len(large_leaves)} launches at B {CB}")}


def ghost_vs_materialized(dev, out_root):
    """The MNIST ghost-clipped real sum (analytic norms, matrix products)
    against the materialized one (vmap(grad), norms, weighted sum), bs 600."""
    import torch
    from csl_gan_tpu_torch.data.mnist import synthetic_mnist
    from csl_gan_tpu_torch.models.common import one_hot
    from csl_gan_tpu_torch.ops import ghost, grads as gops

    _, b = _step_builder(["MNIST", "--conditional", "-dpm", "gc", "--sigma", "10", "-bs",
                          str(BS), "-tss", "60000"], dev, out_root / "ghost_check")
    imgs, labels = synthetic_mnist(BS, seed=13)
    x, y = torch.from_numpy(imgs).to(dev), torch.from_numpy(labels).to(dev)
    st = b.init_state()
    worst = 0.0
    for clip in (st.clipping, 0.05):        # some rows clipped; nearly all
        got, st_g, _ = ghost.vanilla_real_ghost(st.d_params, x, one_hot(y, NC), y,
                                                b.aux_scalar, clip, False)
        f, args = b.real_ps_args(x, y, b.row_weights(y))
        want, st_m = gops.clipped_grad_sum(f, st.d_params, *args, max_norm=clip)
        torch.cuda.synchronize()
        gap = max(rel_l2(got[k], want[k]) for k in b.d_leaves)
        worst = max(worst, gap, rel_l2(st_g.norm_mean, st_m.norm_mean))
        print(f"MNIST real pass bs {BS}, C {clip:g}: ghost vs materialized clipped sum rel l2 "
              f"{gap:.3e} (bound {GHOST_BOUND:g}), clipped {float(st_m.frac_clipped.mean()):.2f}")
    if not worst < GHOST_BOUND:
        fail("the ghost and the materialized clipped sums disagree")


def clip_step_check(dev, out_root, name, argv, batch):
    """One full-width D step through K6 against the same step through K6's
    plain version: same state, inputs and seeds, both on the card."""
    import torch
    from csl_gan_tpu_torch.ops import grads as gops

    opt, b = _step_builder(argv, dev, out_root / f"{name}_step")
    assert b.fused_route
    st0 = b.init_state()
    bs = opt.batch_size
    g = torch.Generator(dev).manual_seed(31)
    x, y = batch(g, bs)
    z = b.gen_z(g, bs)
    leaves = [st0.d_params[k] for k in b.d_leaves]
    stds = torch.tensor(gops.noise_stds(len(leaves), b.sigma, st0.clipping, b.per_layer),
                        device=dev)
    fused = gops.draw_fused_noise(g, leaves, stds)
    pen = {}
    if b.penalty_types:
        pen = dict(pen_x=torch.rand(x.shape, generator=g, device=dev) * 2 - 1, pen_y=y,
                   alphas=[torch.rand((bs, 1, 1, 1), generator=g, device=dev)])

    def step():
        out = b.d_step_gc(st0, x, y, z, fused=fused, **pen)
        torch.cuda.synchronize()
        return out

    cudnn = torch.backends.cudnn
    was = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        (sk, mk) = step()
        with plain_clip():
            (sp, mp) = step()
    finally:
        cudnn.deterministic, cudnn.benchmark = was
    cat = lambda d: torch.cat([d[k].reshape(-1) for k in b.d_leaves])  # noqa: E731
    gaps = {"D params": rel_l2(cat(sk.d_params), cat(sp.d_params)),
            "D mu": rel_l2(cat(sk.d_mu), cat(sp.d_mu)), "D nu": rel_l2(cat(sk.d_nu), cat(sp.d_nu))}
    met = max(float((mk[k] - mp[k]).abs().max() / max(float(mp[k].abs().max()), 1e-2))
              for k in mk if "acc" not in k and k != "frac_clipped")
    print(f"{name} D step (bs {bs}, full width, sigma {b.sigma:g}) on the card, K6 vs plain: "
          f"rel l2 " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + f", metrics {met:.3e} (bound {K6_STEP_BOUND:g}); clipped "
          f"{float(mk['frac_clipped'].mean()):.2f}")
    if not (max(gaps.values()) < K6_STEP_BOUND and met < K6_STEP_BOUND):
        fail(f"the {name} D step through K6 disagrees with the plain step on the card")
    return b, st0, (x, y, z, fused, pen)


def clip_step_breakdown(name, b, st0, inputs):
    """Where one full-width D step's device time goes: vmap(grad), the norms
    and clip factors, the fused sum (K6 and the small leaves), the rest."""
    import torch
    from csl_gan_tpu_torch.ops import grads as gops

    x, y, z, fused, pen = inputs
    fake = b.fakes(st0.g_params, z, y)
    row_w = b.row_weights(y)
    f, args = (b.real_ps_args(x, y, row_w) if b.grad_clip_split
               else b.combined_ps_args(x, y, fake, row_w))
    g_ps = gops.per_sample_grads(f, st0.d_params, *args)
    norms = gops.leaf_norms(g_ps)
    factors = gops.clip_factors(norms, st0.clipping, b.per_layer)
    t = {"vmap(grad)": cuda_ms(lambda: gops.per_sample_grads(f, st0.d_params, *args), 5),
         "norms and factors": cuda_ms(lambda: gops.clip_factors(
             gops.leaf_norms(g_ps), st0.clipping, b.per_layer), 5),
         "K6 + small leaves": cuda_ms(lambda: gops.weighted_sum_fused_noise(
             g_ps, factors, fused), 5)}
    # The same sum and noise unfused (--pallas false): one product and one
    # torch.randn per leaf.
    gen = torch.Generator(x.device).manual_seed(32)
    leaves, stds = list(st0.d_params.values()), fused.stds.tolist()
    unfused = cuda_ms(lambda: [s + n for s, n in zip(
        gops.weighted_sum(g_ps, factors).values(), gops.noise_like(gen, leaves, stds))], 5)
    del g_ps
    step = cuda_ms(lambda: b.d_step_gc(st0, x, y, z, fused=fused, **pen), 5)
    t["the rest (fakes, fake pass, penalty, Adam, metrics)"] = step - sum(t.values())
    print(f"{name} D step breakdown (CUDA events around each part, ms): whole step {step:.3f}; "
          + "; ".join(f"{k} {v:.3f} ({100 * v / step:.1f}%)" for k, v in t.items())
          + f"; beside it, the unfused sum + noise of --pallas false: {unfused:.3f}")


def clip_path(name, argv, tss, out_root, expect_per_step):
    """A materialized path through the Trainer for K6_EPOCHS epochs.
    Returns (ms per D step after the first epoch, K6 launches)."""
    import torch
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.ops import pallas_clip as pc
    from csl_gan_tpu_torch.training.loop import Trainer
    from csl_gan_tpu_torch.training.segment_runner import StepRunner

    e = K6_EPOCHS
    opt = toptions.parse(argv + ["-ne", str(e), "--log_every", str(tss * e), "--manual_seed",
                                 "1", "-o", str(out_root / name)])
    tr = Trainer(opt)
    if not (isinstance(tr.runner, StepRunner) and tr.builder.fused_route):
        fail(f"{name} does not take the step runner's fused route")
    pc.leaf_weighted_sum_noise.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pc.leaf_weighted_sum_noise.launches
    n = tr.n_batches
    if launches != e * n * expect_per_step:
        fail(f"K6 launched {launches} times on {name}, expected {e * n * expect_per_step}")
    ep_ms = [a.elapsed_time(b) for a, b in tr.runner.epoch_events]
    with open(out_root / name / "privacy_log.csv") as fh:
        eps = [float(r["Epsilon"]) for r in csv.DictReader(fh)]
    with open(out_root / name / "log.csv") as fh:
        row = list(csv.DictReader(fh))[-1]
    losses = {k: float(row[k]) for k in ("G Adv Loss", "G Aux Loss", "D Adv Loss", "D Real Loss",
                                         "D Fake Loss", "D Real Aux Loss")}
    if len(eps) != e or not all(math.isfinite(v) and v > 0 for v in eps):
        fail(f"bad epsilon column {eps} on {name}")
    if not all(math.isfinite(v) for v in losses.values()):
        fail(f"non-finite losses on {name}: {losses}")
    if not all(torch.isfinite(t).all() for p in (tr.state.d_params, tr.state.g_params)
               for t in p.values()):
        fail(f"non-finite params after {name}")
    if tr.state.d_count != e * n or tr.state.g_count != e * -(-n // opt.n_d_steps):
        fail(f"D / G update counts {tr.state.d_count} / {tr.state.g_count} on {name}")
    rest = ep_ms[1:] or ep_ms
    step_ms = sum(rest) / len(rest) / n
    print(f"{name}: {e} epochs x {n} D steps ({tr.state.g_count} G updates), K6 launches "
          f"{launches} ({expect_per_step} per D step); ms per D step first epoch "
          f"{ep_ms[0] / n:.3f}, after {step_ms:.3f} (epochs "
          f"{', '.join(f'{v:.1f}' for v in ep_ms)} ms); {opt.batch_size * 1e3 / step_ms:.0f} "
          f"samples/s after the first; wall {wall:.2f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; epsilon {eps[-1]:.6f}; losses "
          + ", ".join(f"{k} {v:.4f}" for k, v in losses.items()))
    profile_step_runner(tr, name)
    return step_ms, launches


def clip_phases(dev, out_root, peak_bytes, k1_epoch_ms, celeba_step_ms):
    """K6's checks and the two materialized paths. Returns K6's kernels-line
    entry."""
    import torch
    from csl_gan_tpu_torch.data.mnist import synthetic_mnist
    from csl_gan_tpu_torch.models.dcresnet import celeba_d64, d_leaves
    from csl_gan_tpu_torch.ops import pallas_clip as pc

    d = celeba_d64(n_classes=2)
    sizes = {k: v.numel() for k, v in d.state_dict().items()}
    large = [(k, sizes[k]) for k in d_leaves(d) if sizes[k] >= pc.MIN_PALLAS_ELEMS]
    print(f"celeba_d64: {sum(sizes.values())} params; leaves the gate (>= "
          f"{pc.MIN_PALLAS_ELEMS} elements) sends to K6: "
          + ", ".join(f"{k} {n}" for k, n in large) + "; small-leaf branch: "
          + ", ".join(f"{k} {sizes[k]}" for k in d_leaves(d) if sizes[k] < pc.MIN_PALLAS_ELEMS))
    entry = clip_kernel_phase(dev, peak_bytes, large)
    ghost_vs_materialized(dev, out_root)

    def mnist_batch(g, bs):
        imgs, labels = synthetic_mnist(bs, seed=14)
        return torch.from_numpy(imgs).to(dev), torch.from_numpy(labels).to(dev)

    def celeba_batch(g, bs):
        return (torch.rand(bs, 64, 64, 3, generator=g, device=dev) * 2 - 1,
                torch.randint(0, 2, (bs,), generator=g, device=dev))

    for name, argv, batch in (("path 1", PATH1, mnist_batch), ("path 2", PATH2, celeba_batch)):
        b, st0, inputs = clip_step_check(dev, out_root, name, argv, batch)
        clip_step_breakdown(name, b, st0, inputs)
        del b, st0, inputs
        torch.cuda.empty_cache()
    ms1, n1 = clip_path("path 1", PATH1, 60000, out_root, 1)
    print(f"path 1 against the K1 path of this run: {ms1 * 100:.3f} ms per 100-step epoch "
          f"against {k1_epoch_ms:.3f} ({ms1 * 100 / k1_epoch_ms:.2f}x)")
    ms2, n2 = clip_path("path 2", PATH2, 1280, out_root, len(large))
    print(f"path 2 against the conv-ghost path of this run: {ms2:.3f} ms per D step against "
          f"{celeba_step_ms:.3f} ({ms2 / celeba_step_ms:.2f}x)")
    entry["launches"] = n1
    entry["path2"]["launches"] = n2
    return entry


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
    peak_flops, peak_bf16, peak_bytes = next(
        ((f, h, b) for key, f, h, b in PEAKS if key in kind), PEAKS[-1][1:])
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
    # The tensor-core kernels of K2 / K3 by name, and any ptxas advisory
    # (C75xx: e.g. wgmma serialised) of their source.
    for fn, report in ptxas_by_kernel(_build.build_logs.get("conv_ghost", "")).items():
        if any(k in fn for k in ("wsum_tc", "ghost_norm_tc", "scale_cotangent")):
            print(f"ptxas conv_ghost {fn}: {report}")
    for line in _build.build_logs.get("conv_ghost", "").splitlines():
        if "(C75" in line or "warning" in line:
            print(f"ptxas conv_ghost: {line.strip()}")
    # K2 / K3's tensor-core variants must hold warpgroup MMA instructions.
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build._target("conv_ghost"))],
                          capture_output=True, text=True) if cuobjdump.exists() else None
    if sass is None:
        print(f"cuobjdump -sass conv_ghost: not run (no {cuobjdump})")
    elif sass.returncode == 0:
        n_hgmma = sass.stdout.count("HGMMA")
        print(f"cuobjdump -sass conv_ghost: {n_hgmma} HGMMA (wgmma) instructions")
        if n_hgmma == 0:
            fail("no HGMMA instruction in the conv_ghost library")
    else:
        print(f"cuobjdump -sass conv_ghost: not run ({sass.stderr.strip()[:200]})")

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

    # 4. The MNIST path through its entry point.
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
    k1_epoch_ms = sum(rest) / len(rest)
    print(f"MNIST path: {e} epochs x {tr.n_batches} steps in one group, K1 launches "
          f"{launches}; epoch ms first {ep_ms[0]:.3f}, rest mean "
          f"{sum(rest) / len(rest):.3f} ({', '.join(f'{x:.3f}' for x in rest)}); "
          f"{samples * len(rest) / (sum(rest) / 1e3):.0f} samples/s after the first; "
          f"wall {wall:.2f} s; epsilon {eps[-1]:.6f}; losses G {losses[0]:.4f} D {losses[1]:.4f}")

    # 5. K1 and plain times at the MNIST path's shapes (one full epoch).
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
    by_kernel = device_ms_by_kernel(prof)
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
        "library_ms": None, "per": f"epoch of {n} steps",
    }]

    # 6. The CelebA path (K2-K5).
    celeba_entries, celeba_step_ms = celeba_phases(dev, out_root, peak_bf16, peak_bytes)
    kernels += celeba_entries

    # 7. The materialized per-sample-gradient paths (K6).
    kernels.append(clip_phases(dev, out_root, peak_bytes, k1_epoch_ms, celeba_step_ms))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
