"""Run ``chip_smoke.py`` and show what it leaves running.

    python3 -m csl_gan_tpu_torch.tools.smoke_watch LOG [DIR] [--args=ARGS]
        [--term-on=TEXT]

Runs ``python3 -u chip_smoke.py [ARGS]`` in DIR (default: the current
directory), writes its standard output and error to LOG with each line
stamped by the seconds since the start, and 0, 2 and 10 s after it exits
lists what is still there (pid: state, parent, process group, session,
command line): the processes of the run, which are this one's descendants
(it is the subreaper of the smoke's orphans), and every process of the
machine that was not there before the smoke started. With ``--term-on``,
sends the smoke SIGTERM when a line of its output first holds TEXT (say,
a line of phase 13's, while its ranks run). Give both with ``=``: ARGS
begins with ``--``. Exits with the smoke's code; prints its elapsed time
and the log's last lines.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shlex
import signal
import subprocess
import sys
import threading
import time


def processes() -> dict:
    """{pid: (state, ppid, pgid, sid, command line)} of every process but
    the kernel's threads (kthreadd, pid 2, and its children)."""
    out = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as fh:
                cmd = fh.read().replace(b"\0", b" ").decode(errors="replace").strip()
            with open(f"/proc/{d}/stat") as fh:
                state, ppid, pgid, sid = fh.read().rsplit(")", 1)[1].split()[:4]
        except (OSError, ValueError):
            continue
        if d != "2" and ppid != "2":
            out[int(d)] = (state, int(ppid), int(pgid), int(sid), cmd[:200])
    return out


def descendants(procs: dict) -> dict:
    """The entries of ``procs`` that descend from this process."""
    ours, grew = {os.getpid()}, True
    while grew:
        grew = False
        for pid, v in procs.items():
            if v[1] in ours and pid not in ours:
                ours.add(pid)
                grew = True
    return {pid: procs[pid] for pid in ours - {os.getpid()}}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 2
    ap = argparse.ArgumentParser(prog="smoke_watch")
    ap.add_argument("log")
    ap.add_argument("dir", nargs="?", default=".")
    ap.add_argument("--args", default="", help="arguments of chip_smoke.py")
    ap.add_argument("--term-on", default=None, help="SIGTERM at the first line holding it")
    args = ap.parse_args(argv)
    if ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")
    before = processes()
    t0 = time.time()
    with open(args.log, "w") as log:
        proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py", *shlex.split(args.args)],
                                cwd=args.dir, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)

        def pump():
            termed = args.term_on is None
            for line in proc.stdout:
                log.write(f"{time.time() - t0:9.2f} {line}")
                log.flush()
                if not termed and args.term_on in line:
                    termed = True
                    proc.send_signal(signal.SIGTERM)
                    log.write(f"{time.time() - t0:9.2f} smoke_watch: SIGTERM sent to the "
                              f"smoke ({proc.pid}) at a line holding {args.term_on!r}\n")
                    log.flush()

        reader = threading.Thread(target=pump, daemon=True)
        reader.start()
        rc = proc.wait()
        t_end = time.time() - t0
        print(f"chip_smoke.py: exit {rc} after {t_end:.1f} s", flush=True)
        for at in (0, 2, 10):
            time.sleep(max(0.0, t0 + t_end + at - time.time()))
            now = processes()
            new = {pid: v for pid, v in now.items() if pid not in before and pid != os.getpid()}
            print(f"processes of the run {at} s after its end: {descendants(now) or 'none'}; "
                  f"new on the machine: {new or 'none'}", flush=True)
        reader.join(timeout=5)
        print("its output pipe: " + ("still open" if reader.is_alive() else "closed"),
              flush=True)
    with open(args.log) as fh:
        print("".join(fh.readlines()[-4:])[-3000:])
    return rc


if __name__ == "__main__":
    sys.exit(main())
