"""The readings that the judge's limits are set from, on the card:
``python3 -m vobench.control --workload <cell> --seeds S [S ...]
[--control-seeds S ...] [--seconds 2]``.

For each seed it runs the cell with a short window at the cell's own load
(set-up, window, the judged sample of chunks, as a benchmark run)
and prints one JSON line of the judge's numbers on the program's outputs
(``"kind": "program"``: the lower readings); for each control seed, also
those of the control, the reference in TF32 in the program's place
(``"kind": "control"``: the upper readings).  All seeds run in one process.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from vobench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m vobench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cell, config, traffic, _, _ = harness.resolve(harness.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("vobench.control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    judged = harness.loop(traffic).judge
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        run = harness.run_cell(cell, config, traffic, seed, args.seconds, False)
        kinds = ([False] if seed in args.seeds else []) + \
            ([True] if seed in args.control_seeds else [])
        for control in kinds:
            t = time.perf_counter()
            readings = judged(config, traffic, run, control)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": "control" if control else "program",
                              "frames": run.frames, "window_s": run.window_s,
                              "judge_s": time.perf_counter() - t,
                              "readings": readings.values}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
