"""Run one cell of the benchmark of the PyTorch / CUDA port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is looked up in ``BENCHMARK.json``
(``--bench`` names another file, such as the tests' tiny one).  A run
makes its weights and rows from ``--seed``, sets up and warms the
program, measures for ``--seconds``, then checks what the timed path
produced against the plain reference in ``portbench/reference/``.  The
last line of standard output is the result; the numbers compared, each
beside its limit, are the last lines of standard error.  ``--trace 1``
reports the per-layer metrics instead of the end-to-end ones, from the
same window and a profiled segment after it.

A cell on several chips starts one process per card (``MCA_COORDINATOR``
over ``tcp://localhost``, NCCL); rank 0 prints the result.
``--device cpu`` rehearses a run on the CPU's plain versions of the
kernels (tests only: device metrics are then left out).
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
CACHE = CHECKOUT / ".portbench_cache"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--bench", default=str(CHECKOUT / "BENCHMARK.json"))
    p.add_argument("--data", default=str(CHECKOUT / "portbench"),
                   help="the folder that holds traffic/ and limits/")
    return p.parse_args(argv)


def pin_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
        os.makedirs(os.environ[var], exist_ok=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(argv, chips: int) -> int:
    """Start ``chips`` ranks of this run and wait for all of them; rank 0
    writes the result to this process's standard output."""
    env = dict(os.environ, MCA_COORDINATOR=f"tcp://localhost:{free_port()}",
               MCA_NUM_PROCESSES=str(chips), PORTBENCH_T0=repr(T0))
    procs = []
    for r in range(chips):
        e = dict(env, MCA_PROCESS_ID=str(r), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen([sys.executable, __file__, *argv], env=e,
                                      stdout=None if r == 0 else subprocess.DEVNULL))
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
            rc = rc or p.returncode
    return rc


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse(argv)
    sys.path.insert(0, str(CHECKOUT))
    pin_caches()
    from portbench import harness

    bench = harness.load_json(Path(args.bench))
    cell = harness.find_cell(bench, args.workload)
    chips = int(cell["chips"])
    import torch

    if args.device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        print(f"portbench: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    if chips > 1 and "MCA_PROCESS_ID" not in os.environ:
        return launch(argv, chips)
    from portbench.runner import execute

    t0 = float(os.environ.get("PORTBENCH_T0", T0))
    return execute(args, bench, cell, t0)


if __name__ == "__main__":
    sys.exit(main())
