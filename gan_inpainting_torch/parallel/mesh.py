"""The ``(data, model, spatial)`` mesh of a config, and what the port runs
of it.

``MeshConfig`` keeps the JAX package's fields and :meth:`MeshConfig.resolve`
its semantics letter for letter, so a config embedded in an export parses
and means the same thing in both packages. The port runs the ``data``
axis only:

* training resolves the mesh over the world size, one process per card as
  ``torchrun`` launches it (:func:`train_mesh`); ``data`` must equal the
  world size, since a rank outside the mesh would idle;
* serving resolves it over the local cards or an explicit device list
  (:func:`build_mesh`); an explicit ``data = n`` takes the first n, as the
  JAX package's device prefix does.

``model`` or ``spatial`` above 1 raises ``NotImplementedError`` in both
places: the model axis (channel sharding) and the spatial axis
(row-sharded attention and conv halos) are ROADMAP Queue 1 items 1 and 2.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

_ROADMAP = {"model": "ROADMAP Queue 1 item 1, the model axis",
            "spatial": "ROADMAP Queue 1 item 2, the spatial axis"}


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. `data=-1` means "all remaining devices"."""

    data: int = -1
    model: int = 1
    spatial: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int]:
        model = self.model
        spatial = self.spatial
        data = self.data
        if data == -1:
            if n_devices % (model * spatial):
                raise ValueError(
                    f"n_devices={n_devices} not divisible by "
                    f"model*spatial={model * spatial}")
            data = n_devices // (model * spatial)
        if data * model * spatial > n_devices:
            raise ValueError(
                f"mesh {data}x{model}x{spatial} needs more than the "
                f"{n_devices} available devices")
        return data, model, spatial


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A resolved mesh: its axis sizes and the devices its data axis
    covers, in order (the ranks, for training)."""

    data: int
    model: int
    spatial: int
    devices: tuple


def _require_data_axis_only(config: MeshConfig) -> None:
    for axis in ("model", "spatial"):
        n = getattr(config, axis)
        if n > 1:
            raise NotImplementedError(
                f"mesh {axis}={n}: the PyTorch port runs the data axis "
                f"only; the {axis} axis awaits {_ROADMAP[axis]}")


def build_mesh(config: MeshConfig, devices: Sequence) -> Mesh:
    """Resolve ``config`` over ``devices`` (a smaller explicit ``data``
    takes their prefix). Raises ``ValueError`` as :meth:`MeshConfig.resolve`
    does and ``NotImplementedError`` for ``model`` or ``spatial`` above
    1."""
    _require_data_axis_only(config)
    devices = tuple(devices)
    data, model, spatial = config.resolve(len(devices))
    return Mesh(data, model, spatial, devices[:data])


def train_mesh(config: MeshConfig, world: int) -> Mesh:
    """The training mesh over ``world`` ranks: its data axis must be every
    rank, so ``data`` other than -1 or the world size raises."""
    mesh = build_mesh(config, range(world))
    if mesh.data != world:
        raise ValueError(
            f"train.mesh.data={config.data} but {world} rank(s) run: each "
            "rank trains one slice of the data axis, so data must be -1 or "
            f"{world} (launch with torchrun --nproc-per-node {mesh.data})")
    return mesh
