"""The drivers that traffic mixes name (``traffic/<mix>.json``
``"driver"``): each builds the program for a cell, warms it, drives the
measured window, frees the program and checks what the window produced
against the reference. One module per driver, found by name.

A driver is a class ``Driver(run)`` with ``setup()``, ``measure()`` (a
record of the window), ``release()``, ``readings(q=None)`` (the numbers
the check compares; with ``q`` the reference at that precision in the
program's place), ``calibration()`` (the readings ``calibrate.py`` prints:
the program's, the float8 control's and the faults') and
``counts(record)`` (the benchmark's own counts over the window, for the
metrics' readers). A driver names no architecture: it reaches the model
through the reference module of the cell's configuration
(``spec.reference``).
"""

from __future__ import annotations

import dataclasses
import importlib
import sys

from benchmark.harness.spec import NAME_RE


@dataclasses.dataclass
class Run:
    """What a driver is given: the cell, its parameters, the seed, the
    window's length, the device, the tracer, and extra program overrides
    (the tests' way to shrink a cell onto the CPU)."""
    cell_name: str
    cell: dict
    params: dict
    seed: int
    seconds: float
    device: object
    tracer: object
    extra_overrides: tuple = ()

    def log(self, msg: str) -> None:
        print(f"[{self.cell_name}] {msg}", file=sys.stderr, flush=True)


def load(name: str):
    if not NAME_RE.match(name):
        raise ValueError(f"driver name {name!r} is not a valid name")
    return importlib.import_module(f"benchmark.harness.drivers.{name}").Driver


def verdict(run: Run, values: dict) -> list[dict]:
    """[{name, value, limit}] for every number the cell's ``limits``
    name, in its order; a number the check could not read is beyond its
    limit."""
    return [{"name": name, "value": values.get(name, float("inf")),
             "limit": float(limit)}
            for name, limit in run.cell["limits"].items()]
