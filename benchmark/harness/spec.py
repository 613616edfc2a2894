"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root,
and beside it under ``benchmark/`` one file per item:

* ``configs/<config>.json``: the configuration as it is run (the
  program's whole config under ``program_config``), its source, and what
  was assumed;
* ``traffic/<mix>.json``: the parameters of a traffic mix and the
  ``driver`` that reads them (``harness/drivers.py``);
* ``workloads/<cell>.json``: a cell's configuration, mix, parameters,
  chips, why, the numbers its check compares with their limits, and its
  end-to-end and per-layer metrics;
* ``metrics/<metric>.py``: a metric's unit, direction, source, layer,
  ``moves`` and reader.

Adding an item is adding its file (and its entry in ``BENCHMARK.json``);
nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _name(kind: str, name: str) -> str:
    if not NAME_RE.match(name):
        raise ValueError(f"{kind} name {name!r} is not a valid name")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_json() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return load_json(BENCH_DIR / "workloads" / f"{_name('cell', name)}.json")


def config(name: str) -> dict:
    return load_json(BENCH_DIR / "configs" / f"{_name('config', name)}.json")


def traffic(name: str) -> dict:
    return load_json(BENCH_DIR / "traffic" / f"{_name('traffic', name)}.json")


def metric(name: str) -> ModuleType:
    """The metric's module ``metrics/<name>.py`` (names hold dots, so it
    is loaded from its file, not imported by package path)."""
    path = BENCH_DIR / "metrics" / f"{_name('metric', name)}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_params(cell: dict) -> dict:
    """The mix's parameters, with the cell's own on top."""
    mix = traffic(cell["traffic"])
    return {**mix.get("params", {}), **cell.get("params", {}),
            "driver": mix["driver"]}


def program_config(cell: dict, extra: list[str] | None = None):
    """The program's ``Config`` of a cell: the configuration file's, the
    cell's ``program_overrides`` on top, then ``extra`` (tests shrink a
    cell to the CPU this way)."""
    from gan_inpainting_torch.configs.base import (
        apply_overrides,
        config_from_dict,
    )

    cfg = config_from_dict(config(cell["config"])["program_config"])
    return apply_overrides(cfg, list(cell.get("program_overrides", []))
                           + list(extra or []))
