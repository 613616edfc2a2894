"""Processes of a parallel run: the process group, this rank's place in
the mesh, its slice of the batch, and its card.

``torchrun --nproc-per-node N -m gan_inpainting_torch train ...`` starts N
processes with ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``
and ``MASTER_PORT`` set; :func:`ensure_initialized` joins them into one
group, NCCL between cards (gloo on the CPU). A process started without
them is a world of one and never touches ``torch.distributed``, so a
single process computes what it computed before the port had ranks. A
caller may set up its own group first (gloo ranks sharing one card, the
CPU tests); :func:`ensure_initialized` then only reports its size.

The ranks form the training mesh's ``data × model × spatial`` grid,
spatial index fastest, then model (parallel/mesh.py): rank r has data
index ``r // (model·spatial)``, model index ``(r // spatial) % model``
and spatial index ``r % spatial``. :func:`set_axes` records the model and
spatial axes' sizes (``parallel/sharding.py use_mesh`` does, beside making
the axes' process groups), and :func:`data_index` / :func:`model_index` /
:func:`spatial_index` / :func:`data_size` read this rank's place from
them. Model and spatial peers (the ranks of one data index) train the
same slice of the batch, so their data and mask streams are keyed on the
data index alone; in a world of the data axis alone the data index is the
rank.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world() -> int:
    return dist.get_world_size() if initialized() else 1


_axes = (1, 1)                  # (model, spatial) of the ranks' mesh


def set_axes(model: int, spatial: int = 1) -> None:
    """Record that the ranks form a mesh with a model axis of ``model`` and
    a spatial axis of ``spatial``: the ``model·spatial`` ranks from
    ``d·model·spatial`` on are data index ``d``'s."""
    global _axes
    n = model * spatial
    if model < 1 or spatial < 1 or world() % n:
        raise ValueError(f"model × spatial axes {model} × {spatial} do not "
                         f"divide the world of {world()} rank(s)")
    _axes = (model, spatial)


def model_size() -> int:
    return _axes[0] if initialized() else 1


def spatial_size() -> int:
    return _axes[1] if initialized() else 1


def data_size() -> int:
    return world() // (model_size() * spatial_size())


def data_index() -> int:
    return rank() // (model_size() * spatial_size())


def model_index() -> int:
    return (rank() // spatial_size()) % model_size()


def spatial_index() -> int:
    return rank() % spatial_size()


def is_main() -> bool:
    """Rank 0 writes the run's record and prints; the others only compute."""
    return rank() == 0


def ensure_initialized(device: str | torch.device = "cpu") -> int:
    """Join the launched processes into one group; returns the world size.

    Already initialized (by the caller): its size. ``WORLD_SIZE`` set (a
    ``torchrun`` launch): ``init_process_group`` over ``env://`` with NCCL
    bound to ``device`` when it is a card, gloo otherwise. Neither: 1,
    without touching ``torch.distributed``."""
    if initialized():
        return dist.get_world_size()
    if "WORLD_SIZE" not in os.environ:
        return 1
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", device_id=device)
    else:
        dist.init_process_group("gloo")
    return dist.get_world_size()


def shutdown() -> None:
    """Leave the group, if one is initialized (the CLI's last step after
    it joined one)."""
    if initialized():
        dist.destroy_process_group()


def process_batch_slice(global_batch: int) -> tuple[int, int]:
    """(this rank's batch size, this rank's seed offset): each data index
    feeds its slice of the global batch from a data stream of its own,
    which its model and spatial peers share (a spatial member cuts its
    row band from the slice); data index 0's offset is 0, so one process
    draws what it always drew."""
    n = data_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"the data axis {n}")
    return global_batch // n, data_index() * 1_000_003


def local_device_index(n_cards: int) -> int | None:
    """This process's card under a launcher (``LOCAL_RANK``), or None when
    not launched. Raises when the launch put more processes on this host
    than it has cards: two ranks never share a card without a word."""
    if "LOCAL_RANK" not in os.environ:
        return None
    index = int(os.environ["LOCAL_RANK"])
    if index >= n_cards:
        raise RuntimeError(
            f"LOCAL_RANK={index} but this host has {n_cards} CUDA "
            f"device(s): launch at most {n_cards} processes per node, or "
            "pass each process its device")
    return index
