"""chip_smoke.py leaves no process behind: its guard stops orphans of its
children, alone (no card, no package beside it) it fails and leaves nothing
running, a SIGTERM or its own deadline stops it and its run as a failure
does, and a SIGKILL takes its children with it."""

import json
import os
import shutil
import signal
import subprocess
import sys
import textwrap
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARD = textwrap.dedent("""
    import json, os, subprocess, sys, time
    sys.path.insert(0, sys.argv[1])
    import chip_smoke as cs
    cs.own_run()
    # An orphan, an orphan in a session of its own, and a child still running.
    quiet = dict(stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
                 stderr=subprocess.DEVNULL)
    subprocess.run(["sh", "-c", "sleep 300 & exit 0"], **quiet)
    subprocess.Popen(["sh", "-c", "sleep 301 &"], start_new_session=True, **quiet).wait()
    child = subprocess.Popen(["sleep", "302"], **quiet)
    time.sleep(0.3)
    found = cs.run_processes()
    cs.stop_run_processes()
    print(json.dumps({"found": sorted(v[1] for v in found.values()),
                      "left": sorted(cs.run_processes())}))
""")


def test_guard_stops_every_process_of_the_run():
    out = subprocess.run([sys.executable, "-c", GUARD, REPO], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["found"] == ["sleep 300", "sleep 301", "sleep 302"], res
    assert res["left"] == [], res
    assert "no process of this run is left" in out.stderr


def test_alone_it_fails_and_leaves_nothing(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    log = tmp_path / "log.txt"
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", "csl_gan_tpu_torch.tools.smoke_watch",
                          str(log), str(tmp_path)], capture_output=True, text=True,
                         timeout=300, env=env, cwd=str(tmp_path))
    assert out.returncode != 0, out.stdout + out.stderr
    for at in (0, 2, 10):
        assert f"processes of the run {at} s after its end: none;" in out.stdout, out.stdout
    text = log.read_text()
    assert "chip_smoke: FAIL" in text
    assert '"ok": true' not in text
    assert "no process of this run is left" in text


# A stand-in smoke: chip_smoke's own guard around a main() that, in phase 13,
# leaves an orphan, starts a child in a session of its own as RankSets starts
# its ranks (through dying_with_us), one that outlives a SIGTERM as a rank
# finishing its epoch does, and a plain child, says their pids and waits to
# be stopped.
STAND_IN = textwrap.dedent("""
    import json, subprocess, sys, time
    sys.path.insert(0, sys.argv[1])
    import chip_smoke as cs
    quiet = dict(stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
                 stderr=subprocess.DEVNULL)

    def main():
        with cs.CLOCK.phase("parallel"):
            subprocess.run(["sh", "-c", "sleep 310 & exit 0"], **quiet)
            subprocess.Popen(cs.dying_with_us(["sleep", "311"]), start_new_session=True,
                             **quiet)
            subprocess.Popen(cs.dying_with_us(["sh", "-c", "trap '' TERM; sleep 314"]),
                             start_new_session=True, **quiet)
            subprocess.Popen(["sleep", "312"], **quiet)
            time.sleep(0.5)
            print(json.dumps(sorted(cs.run_processes())), flush=True)
            time.sleep(float(sys.argv[2]))
        return 0

    cs.CLOCK = cs.Clock()
    sys.exit(cs.guarded(main, deadline_s=float(sys.argv[3])))
""")


def _gone(pid: int) -> bool:
    """No process pid, or only its zombie (exited, not yet reaped by init)."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


def _stand_in(sleep_s: float, deadline_s: float):
    p = subprocess.Popen([sys.executable, "-c", STAND_IN, REPO, str(sleep_s), str(deadline_s)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    pids = json.loads(p.stdout.readline())
    return p, pids


def test_sigterm_stops_the_smoke_and_every_process_of_its_run():
    p, pids = _stand_in(300, 600)
    try:
        assert len(pids) == 5, pids      # sh and its sleep for the one outliving SIGTERM
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == 128 + signal.SIGTERM, err
    assert "FAIL: stopped by SIGTERM in phase parallel" in err, err
    assert "no process of this run is left" in err, err
    assert '"phase_seconds"' in out and '"parallel"' in out, out
    assert all(_gone(pid) for pid in pids), [(pid, _gone(pid)) for pid in pids]


def test_past_its_deadline_the_smoke_fails_naming_the_phase_and_stops_its_run():
    p, pids = _stand_in(300, 3)
    try:
        out, err = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == 1, err
    assert "FAIL: past the smoke's deadline of 3 s in phase parallel, " in err, err
    assert "no process of this run is left" in err, err
    assert all(_gone(pid) for pid in pids), pids


KILLED = textwrap.dedent("""
    import subprocess, sys, time
    sys.path.insert(0, sys.argv[1])
    import chip_smoke as cs
    child = subprocess.Popen(cs.dying_with_us(["sleep", "313"]), start_new_session=True,
                             stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
    print(child.pid, flush=True)
    time.sleep(300)
""")


def test_sigkill_of_the_smoke_takes_its_session_leader_child_with_it():
    p = subprocess.Popen([sys.executable, "-c", KILLED, REPO], stdout=subprocess.PIPE,
                         text=True)
    pid = None
    try:
        pid = int(p.stdout.readline())
        deadline = time.time() + 30          # the child has become sleep (prctl done)
        while time.time() < deadline:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                if fh.read().split(b"\0")[0] == b"sleep":
                    break
            time.sleep(0.05)
        with open(f"/proc/{pid}/stat") as fh:
            assert int(fh.read().rsplit(")", 1)[1].split()[3]) == pid  # its own session
        p.kill()
        p.wait(10)
        deadline = time.time() + 5
        while not _gone(pid) and time.time() < deadline:
            time.sleep(0.05)
        assert _gone(pid), f"the child {pid} outlived the SIGKILLed smoke by 5 s"
    finally:
        if p.poll() is None:
            p.kill()
        if pid is not None and not _gone(pid):
            os.kill(pid, signal.SIGKILL)
