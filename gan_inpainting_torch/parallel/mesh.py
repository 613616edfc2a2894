"""The ``(data, model, spatial)`` mesh of a config, and what the port runs
of it.

``MeshConfig`` keeps the JAX package's fields and :meth:`MeshConfig.resolve`
its semantics letter for letter, so a config embedded in an export parses
and means the same thing in both packages. The port runs all three axes in
training and serving, laid out as the JAX package lays out its devices
(``devices.reshape(data, model, spatial)``): the spatial index varies
fastest, then the model index, so device ``r`` has data index
``r // (model·spatial)``, model index ``(r // spatial) % model`` and
spatial index ``r % spatial``. At ``spatial = 1`` that is model index
fastest, and the members of one model group are neighbours.

* training resolves the mesh over the world size, one process per card as
  ``torchrun`` launches it (:func:`train_mesh`); ``data × model ×
  spatial`` must be the world size, since a rank outside the mesh would
  idle;
* serving resolves it over the local cards or an explicit device list
  (:func:`build_mesh`); an explicit ``data = n`` takes the first
  ``n × model × spatial``, as the JAX package's device prefix does. Each
  data index is one replica: a group of ``model × spatial`` devices
  (:attr:`Mesh.groups`), member ``r`` of a group at model index
  ``r // spatial`` and spatial index ``r % spatial``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

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
    """A resolved mesh: its axis sizes and the ``data × model × spatial``
    devices it covers, in mesh order (the ranks, for training): spatial
    index fastest, then model."""

    data: int
    model: int
    spatial: int
    devices: tuple

    @property
    def groups(self) -> tuple[tuple, ...]:
        """The devices of each data index: one group of ``model ×
        spatial`` each, member ``r`` at model index ``r // spatial`` and
        spatial index ``r % spatial``."""
        n = self.model * self.spatial
        return tuple(self.devices[i * n:(i + 1) * n]
                     for i in range(self.data))


def build_mesh(config: MeshConfig, devices: Sequence) -> Mesh:
    """Resolve ``config`` over ``devices`` (a smaller explicit ``data``
    takes their prefix). Raises ``ValueError`` as :meth:`MeshConfig.resolve`
    does."""
    devices = tuple(devices)
    data, model, spatial = config.resolve(len(devices))
    return Mesh(data, model, spatial, devices[:data * model * spatial])


def train_mesh(config: MeshConfig, world: int) -> Mesh:
    """The training mesh over ``world`` ranks: ``data × model × spatial``
    must be every rank, so ``data`` other than -1 or ``world / (model ·
    spatial)`` raises ``ValueError``."""
    mesh = build_mesh(config, range(world))
    if mesh.data * mesh.model * mesh.spatial != world:
        per = mesh.model * mesh.spatial
        raise ValueError(
            f"train.mesh.data={config.data} but {world} rank(s) run: each "
            "rank trains one slice of the data axis, so data must be -1 or "
            f"{world // per} (launch with torchrun --nproc-per-node "
            f"{mesh.data * per})")
    return mesh
