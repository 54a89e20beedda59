"""The check's control: the reference computed in fp8, the precision below
the cells' bf16 (`bench.reference.decoder`, ``precision="fp8"``), put in
the program's place.

    python3 bench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

Each seed is one run of the cell at its own load (`bench.harness.run_cell`
with ``judged="fp8"``, a short window long enough to serve the sample).
The tokens that fp8 ranks first at the served positions go through the
run's own checks and the cell's committed limit, and must come out not
correct.  Beside each, the program's own reading of the same run.  One
JSON line per seed; exits 1 if any control came out correct.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    from bench import harness

    t_start = T_START
    passed = []
    for seed in args.seeds:
        res = harness.run_cell(args.workload, seed, args.seconds, False, t_start, root=ROOT,
                               judged="fp8")
        limit = res["checks"]["logit_gap"]["limit"]
        print(json.dumps({"workload": args.workload, "seed": seed, "program": res["control"]["fp32"],
                          "control": res["control"]["fp8"], "limit": limit,
                          "program_within": res["control"]["fp32"] <= limit and not res["failed"],
                          "control_correct": res["correct"], "metrics": res["metrics"]}),
              flush=True)
        if res["correct"]:
            passed.append(seed)
        t_start = time.perf_counter()
    if passed:
        print(f"the control came out correct on seeds {passed}", file=sys.stderr)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
