"""Readings from which a cell's check limits are set. Not part of a
benchmark run: run on the card by hand.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--seconds 3]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, then one JSON line with the compared numbers of the
program (sound runs: the lower reading), of the control (the reference
computed with its operands rounded to float8 in the program's place:
the upper reading) and of the faults a check must catch (serving: half of
the compared images left unfilled, one answer swapped for another's;
training: half of each batch left out, in the reference put in the
program's place; a state left unchanged reads 1 and needs no run).

Training also prints the look at its worst leaves: for the three leaves
with the widest gap of first-gradient norms and of change norms, the
gap, the leaf's size, its reference first gradient over the median
leaf's, and ``dir_err``, the norm of the difference between the
program's and the reference's first gradient of the leaf over the
reference's norm (about 1 where the leaf's gradient is rounding).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from benchmark import run as bench_run  # noqa: E402  (sets the caches)


def serve_readings(d) -> dict:
    from benchmark.harness import serving
    from benchmark.reference import deepfill

    run = d.run
    imgs, masks, got = d.compared()
    f, block = d.cfg.model.base_features, int(run.params["ref_block"])
    ref = serving.reference_u8(d.params, imgs, masks, f, run.device, block)
    ctl = serving.reference_u8(d.params, imgs, masks, f, run.device, block,
                               deepfill.fp8)
    half = got.copy()
    n = len(half) // 2
    half[n:] = imgs[n:] * (masks[n:] <= 0)
    swapped = got.copy()
    swapped[0] = got[1]
    hole = np.broadcast_to(masks > 0, got.shape)
    out = {}
    for name, x in (("program", got), ("control_fp8", ctl),
                    ("fault_half", half), ("fault_swapped", swapped)):
        out[name] = serving.compare(x, imgs, masks, ref)
        diff = np.abs(x.astype(np.int16) - ref.astype(np.int16))[hole]
        out[name].update(hole_mad_all=float(diff.mean()),
                         hole_maxdiff=int(diff.max()),
                         hole_share_ge2=float((diff >= 2).mean()))
    return out


def train_readings(d) -> dict:
    """The compared numbers of the program, the control and the half-batch
    fault, with the look at the program's worst leaves beside them (not
    compared)."""
    from benchmark.harness.drivers.train_steps import _keep, leaf_gaps
    from benchmark.reference import deepfill

    ref = d.reference()
    med = float(np.median(list(ref["first"].values())))
    out = {"left_out": sorted(set(ref["first"]) - _keep(ref))}
    for name, x in (("program", d.program_readings()),
                    ("control_fp8", d.reference(q=deepfill.fp8)),
                    ("fault_half", d.reference(half=True))):
        out[name] = d.compare(x, ref)
        for what, lg in (("grad", leaf_gaps(x["first"], ref["first"])),
                         ("change", leaf_gaps(x["changes"], ref["changes"],
                                              _keep(ref)))):
            worst = sorted(lg, key=lg.get)[-3:][::-1]
            out[name][f"worst_{what}"] = [
                _look(k, lg[k], x, ref, med) for k in worst]
    return out


def _look(leaf: str, gap: float, got: dict, ref: dict, med: float) -> dict:
    g = "g." + leaf[4:] if leaf.startswith("ema.") else leaf
    look = {"leaf": leaf, "gap": gap,
            "first_over_median": ref["first"][g] / med}
    want, have = ref["first_vecs"].get(g), got["first_vecs"].get(g)
    if want is not None and have is not None:
        look["numel"] = want.numel()
        look["dir_err"] = float((have - want).norm()
                                / want.norm().clamp(min=1e-30))
    return look


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
        read = (train_readings(d) if params["driver"] == "train_steps"
                else serve_readings(d))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "setup_s": setup_s, "window": {
                              k: v for k, v in rec.items()
                              if isinstance(v, (int, float))},
                          "peak_bytes": peak, **read}), flush=True)
        del d
        bench_run.log(f"seed {seed} done at {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
