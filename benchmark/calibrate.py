"""Readings from which a cell's check limits are set. Not part of a
benchmark run: run on the card by hand.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--seconds 3]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, then one JSON line with what the cell's driver reads for
calibration (its ``calibration()``): the compared numbers of the program
(sound runs: the lower reading), of the control (the reference computed
with its operands rounded to float8 in the program's place: the upper
reading) and of the faults a check must catch (serving: half of the
compared images left unfilled, one answer swapped for another's;
training: half of each batch left out, in the reference put in the
program's place, with the look at the worst leaves; a state left
unchanged reads 1 and needs no run).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run as bench_run  # noqa: E402  (sets the caches)


def main(argv=None) -> int:
    import torch

    from benchmark.harness import drivers, spec
    from benchmark.harness.trace import Tracer

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = spec.workload(args.workload)
    params = {**spec.cell_params(cell), "keep_vectors": True}
    device = torch.device("cuda", 0)
    for seed in [int(s) for s in args.seeds.split(",")]:
        run = drivers.Run(args.workload, cell, params, seed, args.seconds,
                          device, Tracer(False))
        d = drivers.load(params["driver"])(run)
        t0 = time.perf_counter()
        d.setup()
        setup_s = time.perf_counter() - t0
        rec = d.measure()
        peak = torch.cuda.max_memory_allocated(device)
        d.release()
        read = d.calibration()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "setup_s": setup_s, "window": {
                              k: v for k, v in rec.items()
                              if isinstance(v, (int, float))},
                          "peak_bytes": peak, **read}), flush=True)
        del d
        bench_run.log(f"seed {seed} done at {time.perf_counter() - t0:.1f} s, "
                      "peak device memory with the check "
                      f"{torch.cuda.max_memory_allocated(device)} B")
    return 0


if __name__ == "__main__":
    sys.exit(main())
