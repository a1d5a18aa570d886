"""Readings that set a cell's correctness limits, on the chip, in one
process: the numbers compared for sound runs of the program over many
seeds, for the control (the plain reference computed in bfloat16 in the
program's place) and for each planted fault (harness/faults.py), each
after a short window at the cell's own size and load.

    python benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        --seconds 3 [--control 1,2,3] [--faults unchanged,half,altered]

Prints one JSON line a reading: {"workload", "seed", "kind", "numbers"};
a fault's numbers say whether the cell runs what it breaks (`applies`).
The benchmark's own runs never run this.
"""

import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(HERE / ".cache" / sub)
sys.path[:0] = [str(HERE), str(HERE.parent)]

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from harness import cli, faults  # noqa: E402


def _ints(s):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=_ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=0,
                    help="bodies (a CPU rehearsal only; 0: the cell's)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    def emit(seed, kind, nums):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "kind": kind, "numbers": nums}), flush=True)

    quiet = lambda s: None  # noqa: E731
    scale = {"n": args.n} if args.n else None
    for seed in args.seeds:
        res, info = cli.run_cell(args.workload, seed, args.seconds, False,
                                 device=args.device, out=quiet, scale=scale,
                                 control=seed in args.control)
        nums = dict(info["numbers"])
        nums.update({k: info[k] for k in ("pairs", "tainted",
                                          "steps", "reference_s")})
        emit(seed, "program", nums)
        if "control" in info:
            emit(seed, "control", info["control"])
    for name in [f for f in args.faults.split(",") if f]:
        for seed in args.fault_seeds:
            _, info = cli.run_cell(args.workload, seed, args.seconds, False,
                                   device=args.device, out=quiet,
                                   scale=scale,
                                   fault=faults.plant(name, seed))
            nums = dict(info["numbers"])
            nums["applies"] = faults.applies(name, info["resolved"])
            emit(seed, name, nums)
    return 0


if __name__ == "__main__":
    sys.exit(main())
