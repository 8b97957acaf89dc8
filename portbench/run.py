"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds `BENCHMARK.json`, this folder
and the program (`vireo_tpu_torch`). It runs on the CUDA cards of the
machine it is started on and needs as many as the cell asks for. The
last line of standard output is the result, one JSON object; everything
else the run prints goes to standard error, the numbers compared for
`correct`, each beside its limit, last.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # the result alone goes to standard output: every other print of the
    # run, the program's and the libraries' too, to standard error
    result_fd = os.dup(1)
    os.dup2(2, 1)
    sys.path.insert(0, str(ROOT))
    # a library that would load JAX by itself is kept from doing so
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")

    import torch
    from portbench.harness.manifest import Manifest
    from portbench.harness.run_cell import forbidden_modules, run_cell

    chips = Manifest(ROOT).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("the cell asks for %d CUDA card(s); this machine has %d"
              % (chips, torch.cuda.device_count()
                 if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    out, lines = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), torch.device("cuda"), T_START,
                          root=ROOT, log=lambda m: print(m, file=sys.stderr))
    for line in lines:
        print(line, file=sys.stderr)
    # what the comparison loaded after the window counts too
    loaded = forbidden_modules()
    if loaded:
        print("modules of JAX or the JAX package were loaded: "
              + ", ".join(loaded), file=sys.stderr)
        return 3
    sys.stderr.flush()
    sys.stdout.flush()
    os.write(result_fd, (json.dumps(out) + "\n").encode())
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # no exit-time output of a library may follow the result line
    os._exit(code)
