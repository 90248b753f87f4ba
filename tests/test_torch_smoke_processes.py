"""chip_smoke.py leaves no process behind: its guard stops orphans of its
children, and alone (no card, no package beside it) it fails and leaves
nothing running."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

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
