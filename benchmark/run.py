"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads and warms the program (set-up), measures for ``--seconds``, frees
the program, checks what the window produced against the plain float32
reference, and prints as the last line of standard output one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` also ``breakdown``, and last ``checked``
(each compared number with its limit, also the last lines of standard
error). Everything else goes to standard error.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with 2 and prints no result; so it does if the program pulled in JAX.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / ".bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda_jit")
os.environ["USE_FLAX"] = "0"

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gan_inpainting_tpu"})


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    Flax's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,"
             "power.limit,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip()


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             extra_overrides=(), extra_params=None,
             t_start: float | None = None) -> dict:
    """One run of a cell on ``device``; returns the result object. The
    tests call this on the CPU with ``extra_overrides`` (of the program's
    config) and ``extra_params`` (of the mix) that shrink the cell."""
    import torch

    from benchmark.harness import drivers, spec
    from benchmark.harness.trace import Tracer

    t_start = T_START if t_start is None else t_start
    cell = spec.workload(name)
    params = {**spec.cell_params(cell), **(extra_params or {})}
    cuda = device.type == "cuda"
    tracer = Tracer(trace)
    run = drivers.Run(name, cell, params, seed, seconds, device, tracer,
                      tuple(extra_overrides))
    driver = drivers.load(params["driver"])(run)
    tracer.warm()
    driver.setup()
    if cuda:
        torch.cuda.synchronize(device)
        log(f"[{name}] before the window: {nvidia_smi()}")
    setup_s = time.perf_counter() - t_start
    record = driver.measure()
    if cuda:
        log(f"[{name}] after the window: {nvidia_smi()}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    driver.release()
    if cuda:
        from gan_inpainting_torch.ops import dispatch

        log(f"[{name}] kernel launches: {dict(dispatch.launches)}")
    log(f"[{name}] set-up {setup_s:.3f} s, window {record['seconds']:.3f} s,"
        f" peak device memory {peak} B")
    log(f"[{name}] host spans, mean ms (count): " + ", ".join(
        f"{k} {1e3 * sum(v) / len(v):.3f} ({len(v)})"
        for k, v in tracer.host.items() if v))
    if tracer.summary:
        s = tracer.summary
        log(f"[{name}] trace: {s['device_events']} device events, marker "
            f"found {s['marker_found']}, clock offset "
            f"{s['clock_offset_ns']} ns, busy {s['busy_s']:.4f} s of "
            f"{s['window_s']:.4f} s")
    t_check = time.perf_counter()
    checked = drivers.verdict(run, driver.readings())
    log(f"[{name}] check took {time.perf_counter() - t_check:.3f} s")
    correct = (record["attempted"] > 0
               and all(c["value"] <= c["limit"] for c in checked))
    counts = driver.counts(record) if trace else {}
    ctx = SimpleNamespace(record=record, setup_s=setup_s, counts=counts,
                          trace=tracer.summary, spans=dict(tracer.host))
    metrics = {}
    for m in cell["per_layer" if trace else "end_to_end"]:
        mod = spec.metric(m)
        value = mod.read(ctx)
        if value is not None:
            metrics[m] = {"value": float(value), "unit": mod.UNIT}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(record["attempted"]),
              "failed": int(record["failed"]), "metrics": metrics,
              "device": dev}
    if trace and tracer.summary:
        s = tracer.summary
        dev["busy_s"], dev["window_s"] = s["busy_s"], s["window_s"]
        top = sorted(s["kernels_s"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(s["idle_by_span_s"].items(), key=lambda kv: -kv[1])
        result["breakdown"] = {"device_ops": [[k[:160], v] for k, v in top],
                               "idle_gaps": [[k, v] for k, v in gaps[:10]]}
    result["checked"] = {c["name"]: {"value": c["value"],
                                     "limit": c["limit"]} for c in checked}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import spec

    chips = {w["name"]: int(w["chips"])
             for w in spec.benchmark_json()["workloads"]}
    if args.workload not in chips:
        log(f"unknown workload {args.workload!r}; have {sorted(chips)}")
        return 2
    import torch

    if not torch.cuda.is_available():
        log("no CUDA card: the benchmark runs only on one")
        return 2
    if torch.cuda.device_count() < chips[args.workload]:
        log(f"{args.workload} needs {chips[args.workload]} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {bad}: the benchmark may not load JAX or the "
            "JAX package")
        return 3
    for name, c in result["checked"].items():
        log(f"checked {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
