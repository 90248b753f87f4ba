"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the port (``csl_gan_tpu_torch``). Each run builds the cell's Trainer
from its workload file, warms up, measures ``Trainer.run`` over whole
epochs for ``--seconds``, checks the first steps against the plain
reference and prints one JSON line last: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics read from a
profiled stretch. It needs a CUDA device, and fails without one; it fails
too if the JAX package or JAX was loaded. It leaves the host's cores and
torch's threads as ``python -m csl_gan_tpu_torch.train`` leaves them.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent))

from harness import driver, manifest  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cells = [w["name"] for w in manifest.manifest()["workloads"]]
    if a.workload not in cells:
        print(f"unknown workload {a.workload!r}; BENCHMARK.json has {cells}", file=sys.stderr)
        return 2
    want = next(w["chips"] for w in manifest.manifest()["workloads"] if w["name"] == a.workload)
    driver.cache_env(manifest.root())
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        print(f"the cell needs {want} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    result = driver.run(a.workload, a.seed, a.seconds, bool(a.trace), T0)
    found = driver.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
