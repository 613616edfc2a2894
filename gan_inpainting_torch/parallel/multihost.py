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

The ranks form the training mesh's ``data × model`` grid, model index
fastest (parallel/mesh.py): :func:`set_model_axis` records the model
axis's size (``parallel/sharding.py use_mesh`` does, beside making the
axes' process groups), and :func:`data_index` / :func:`model_index` /
:func:`data_size` read this rank's place from it. Model peers train the
same slice of the batch; in a world without a model axis the data index is
the rank.
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


_model_axis = 1                 # the model axis of the mesh the ranks form


def set_model_axis(n: int) -> None:
    """Record that the ranks form a mesh with a model axis of ``n``: ranks
    ``d·n … d·n + n − 1`` are data index ``d``'s model group."""
    global _model_axis
    if n < 1 or world() % n:
        raise ValueError(f"model axis {n} does not divide the world of "
                         f"{world()} rank(s)")
    _model_axis = n


def model_size() -> int:
    return _model_axis if initialized() else 1


def data_size() -> int:
    return world() // model_size()


def data_index() -> int:
    return rank() // model_size()


def model_index() -> int:
    return rank() % model_size()


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
    which its model peers share; data index 0's offset is 0, so one
    process draws what it always drew."""
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
