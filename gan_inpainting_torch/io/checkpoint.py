"""Checkpoints of the full train state with ``torch.save``.

``<workdir>/<subdir>/step_<N>.pt`` holds the state's ``state_dict`` (G and
D parameters, spectral vectors, both Adam states, the EMA, the step) and
``step_<N>.json`` beside it the config, so eval and serving can rebuild the
state without the training command line. The newest ``max_to_keep`` steps
are kept. Files are written under a temporary name and renamed, so a
killed run leaves no half-written checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
from typing import TYPE_CHECKING

import torch

from gan_inpainting_torch.configs.base import Config

if TYPE_CHECKING:  # import cycle: train.state restores through this module
    from gan_inpainting_torch.train.state import GANTrainState

_NAME = re.compile(r"step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, workdir: str, max_to_keep: int = 3,
                 subdir: str = "checkpoints"):
        self.path = pathlib.Path(workdir) / subdir
        self.path.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self.path.iterdir()
                      if (m := _NAME.match(p.name)))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def _file(self, step: int, suffix: str) -> pathlib.Path:
        return self.path / f"step_{step}{suffix}"

    def save(self, step: int, state: "GANTrainState", cfg: Config) -> None:
        for suffix, write in (
                (".json", lambda f: f.write(json.dumps(
                    dataclasses.asdict(cfg), indent=2).encode())),
                (".pt", lambda f: torch.save(state.state_dict(), f))):
            tmp = self._file(step, suffix + ".tmp")
            with open(tmp, "wb") as f:
                write(f)
            os.replace(tmp, self._file(step, suffix))
        for old in self.steps()[:-self.max_to_keep]:
            self._file(old, ".pt").unlink(missing_ok=True)
            self._file(old, ".json").unlink(missing_ok=True)

    def _resolve(self, step: int | None) -> int:
        step = self.latest_step() if step is None else step
        if step is None or not self._file(step, ".pt").exists():
            raise FileNotFoundError(f"no checkpoint under {self.path}")
        return step

    def restore_raw(self, step: int | None = None,
                    map_location="cpu") -> dict:
        """The saved ``state_dict`` as plain nested dicts of tensors."""
        return torch.load(self._file(self._resolve(step), ".pt"),
                          map_location=map_location, weights_only=True)

    def restore(self, state: "GANTrainState",
                step: int | None = None) -> "GANTrainState":
        """Load a checkpoint into ``state`` (built for the same config).
        Tensors are read to the CPU and copied from there, so the Adam step
        counters stay on the host as a fresh optimizer keeps them."""
        state.load_state_dict(self.restore_raw(step))
        return state

    def restore_config(self, step: int | None = None) -> dict:
        return json.loads(self._file(self._resolve(step), ".json")
                          .read_text())
