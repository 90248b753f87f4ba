"""SIGTERM to the port's training CLI on the CPU (as tests/test_preempt.py
does for the JAX package): the run finishes its current epoch group, prints
the preempt message, saves, and exits 0; a resume from that save continues
epsilon from the ledger."""

import csv
import os
import signal
import subprocess
import sys
import time

from csl_gan_tpu_torch import train as port_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _privacy_rows(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [r for r in csv.reader(f) if r and r[0] != "Epoch"]


def test_sigterm_saves_exits_zero_and_resumes(tmp_path):
    out = str(tmp_path / "p")
    argv = [sys.executable, "-m", "csl_gan_tpu_torch.train", "MNIST", "--conditional",
            "-dpm", "gc", "-tss", "200", "-bs", "40", "-ne", "100000",
            "--manual_seed", "2", "--platform", "cpu", "--log_every", "200",
            "--save_every", "100000", "-o", out]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.Popen(argv, env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 300
        while len(_privacy_rows(out + "/privacy_log.csv")) < 2:
            if p.poll() is not None:
                raise AssertionError("the CLI exited early:\n" + p.communicate()[0])
            if time.time() > deadline:
                raise AssertionError("no training progress before the deadline")
            time.sleep(0.2)
        p.send_signal(signal.SIGTERM)
        text, _ = p.communicate(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    assert p.returncode == 0, text
    assert "Preempted after epoch" in text and "Finished training." in text, text

    labels = sorted(int(f.split("-")[1]) for f in os.listdir(out + "/saves")
                    if f.startswith("G-"))
    n = labels[-1]
    assert os.path.exists(out + f"/saves/D-{n}")
    rows = _privacy_rows(out + "/privacy_log.csv")
    assert len(rows) == n and int(rows[-1][0]) == n - 1
    eps_preempt = float(rows[-1][1])

    port_train.main(["MNIST", "-rp", out, "-re", str(n), "-ne", str(n + 1),
                     "-ka", "n_epochs", "--platform", "cpu"])
    rows = _privacy_rows(out + "/privacy_log.csv")
    assert len(rows) == n + 1 and float(rows[-1][1]) > eps_preempt
    assert os.path.exists(out + f"/saves/G-{n + 1}")


def test_handler_is_restored_and_only_installed_on_the_main_thread(tmp_path):
    import threading

    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.training.loop import Trainer

    def marker(signum, frame):
        pass

    args = ["MNIST", "--conditional", "-dpm", "gc", "-tss", "80", "-bs", "40", "-ne", "1",
            "--log_every", "80", "--platform", "cpu"]
    prev = signal.signal(signal.SIGTERM, marker)
    try:
        Trainer(toptions.parse(args + ["-o", str(tmp_path / "main")])).run()
        assert signal.getsignal(signal.SIGTERM) is marker
        seen = []
        tr = Trainer(toptions.parse(args + ["-o", str(tmp_path / "thread")]))
        t = threading.Thread(target=lambda: seen.append(tr.run()))
        t.start()
        t.join(timeout=120)
        assert not t.is_alive() and seen == [0]
        assert signal.getsignal(signal.SIGTERM) is marker
    finally:
        signal.signal(signal.SIGTERM, prev)
