"""A run with its timed path broken underneath, driven through the harness
on the CPU without the look for a card, comes out not correct: once for
each fault a one-chip training cell can have (a step that returns its state
unchanged; half of the batch left out, the mean taken over the rest), and,
on the K1 cell, a launch of several steps that feeds every step its first
step's draws or rows (the check drives such a launch, as the window does).
"""

import time

import pytest

from bench_cases import CELLS, tiny
from harness import driver


def unchanged_state(trainer):
    """Every step of the runner returns the state it was given."""
    from csl_gan_tpu_torch.training.segment_runner import EpochsRunner
    runner = trainer.runner
    step = runner.run_segment
    if isinstance(runner, EpochsRunner):
        def segment(state, *args, **kwargs):
            return state, step(state, *args, **kwargs)[1]
    else:
        def segment(state, *args, **kwargs):
            step(state, *args, **kwargs)
            return state
    runner.run_segment = segment


def _half(t):
    if t is None:
        return None
    if isinstance(t, (list, tuple)):
        return [_half(x) for x in t]
    return t[: t.shape[0] // 2]


def half_batch(trainer):
    """Each D step sees the first half of its batch and takes the mean over
    it (the K1 path's plain D step on the CPU; the step runner's D step)."""
    from csl_gan_tpu_torch.training.segment_runner import EpochsRunner
    b = trainer.builder
    if isinstance(trainer.runner, EpochsRunner):
        step = b.d_step

        def d_step(state, x, y, z, noise, use_dp, fake=None):
            return step(state, _half(x), _half(y), _half(z), noise, use_dp, fake=_half(fake))
        b.d_step = d_step
    else:
        core = b.d_core

        def d_core(state, x, y, z, use_dp, **kw):
            for key in ("pen_x", "pen_y", "alphas", "valid", "fake"):
                if key in kw:
                    kw[key] = _half(kw[key])
            return core(state, _half(x), _half(y), _half(z), use_dp, **kw)
        b.d_core = d_core


@pytest.mark.parametrize("fault", [unchanged_state, half_batch])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(cell, fault, data_root):
    res = driver.run(cell, 11, 0.1, False, time.time(), device="cpu",
                     overrides=tiny(cell, data_root), plant=fault, log=lambda *a: None)
    assert res["correct"] is False, res["checks"]
    failed = [k for k, c in res["checks"].items() if not c["value"] <= c["limit"]]
    assert failed


def _first_step(t, n):
    return t[: t.shape[0] // n].repeat((n,) + (1,) * (t.dim() - 1))


def first_step_draws(trainer):
    """Each K1 launch feeds every step the z, labels and noise of its first."""
    runner, draw = trainer.runner, trainer.runner.draw

    def segment_draws(*args, **kwargs):
        rows, z_d, z_g, ohg, noise = draw(*args, **kwargs)
        n = z_d.shape[0]
        return (rows, _first_step(z_d, n), _first_step(z_g, n), _first_step(ohg, n),
                None if noise is None else [_first_step(x, n) for x in noise])
    runner.draw = segment_draws


def first_step_rows(trainer):
    """Each K1 launch trains every step on the rows of its first."""
    runner, draw = trainer.runner, trainer.runner.draw

    def segment_draws(*args, **kwargs):
        rows, z_d, z_g, ohg, noise = draw(*args, **kwargs)
        return (_first_step(rows, z_d.shape[0]), z_d, z_g, ohg, noise)
    runner.draw = segment_draws


@pytest.mark.parametrize("fault", [first_step_draws, first_step_rows])
def test_a_launch_that_repeats_its_first_step_is_not_correct(fault, data_root):
    cell = CELLS[0]
    res = driver.run(cell, 12, 0.1, False, time.time(), device="cpu",
                     overrides=tiny(cell, data_root), plant=fault, log=lambda *a: None)
    assert res["correct"] is False, res["checks"]
