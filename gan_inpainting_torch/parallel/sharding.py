"""The port's collectives, in one place.

Data parallelism over ranks: every rank holds the whole train state and
trains its slice of the global batch. State is made equal once, by a
broadcast from rank 0 (:func:`broadcast_module_state`, after create,
resume or warm start); the gradients are averaged by hand once per
optimizer step (:func:`all_reduce_mean_`), since the step takes them with
``torch.autograd.grad`` and ``DistributedDataParallel`` reduces only what
``.backward()`` writes into ``.grad``. Identical weights and identical
averaged gradients then keep the ranks bit-identical step after step, the
spectral-norm vectors included (they advance from the weights alone).

Only ``all_reduce``, ``broadcast`` and ``barrier`` are used. NCCL takes
them between cards, and gloo takes them on CUDA tensors too (staged
through the host), so two gloo ranks sharing one card run the same code
an n-card NCCL run does: that is how a one-card machine checks it. A
gather is an ``all_reduce`` over a zero-filled buffer
(:func:`all_gather_rows`), which is exact.

With no process group initialized every function is the identity and
issues no collective, so a single process computes what it always did. In
a group of one each still issues its collective, whose result equals its
input. ``counts["all_reduce_mean_"]`` counts the gradient reduces (the
run's record logs it as ``grad_all_reduces``).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch
import torch.distributed as dist

from gan_inpainting_torch.parallel.multihost import initialized, rank, world

BUCKET_BYTES = 64 << 20           # largest flat buffer per collective

counts: dict[str, int] = {"all_reduce_mean_": 0}


def _buckets(tensors: Sequence[torch.Tensor], itemsize: int):
    """Consecutive groups of at most BUCKET_BYTES (a larger tensor alone)."""
    group, size = [], 0
    for t in tensors:
        n = t.numel() * itemsize
        if group and size + n > BUCKET_BYTES:
            yield group
            group, size = [], 0
        group.append(t)
        size += n
    if group:
        yield group


def _host_device() -> torch.device:
    """Where small host values go to be reduced: the rank's card under
    NCCL, which takes only CUDA tensors; else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if initialized():
        dist.barrier()


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over ranks, in place: one flat
    float32 buffer per bucket of at most ``BUCKET_BYTES``."""
    if not initialized():
        return
    counts["all_reduce_mean_"] += 1
    n = world()
    for group in _buckets(tensors, 4):
        flat = torch.cat([t.reshape(-1).float() for t in group])
        dist.all_reduce(flat)
        flat /= n
        parts = flat.split([t.numel() for t in group])
        torch._foreach_copy_(list(group),
                             [p.view_as(t) for p, t in zip(parts, group)])


def mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over ranks, outside autograd (a loss's
    normalizer); ``t`` itself with no group."""
    if not initialized():
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t / world()


def _state_tensors(modules: Iterable[torch.nn.Module], optimizers,
                   extra) -> list[torch.Tensor]:
    tensors = [t for m in modules for t in m.state_dict().values()]
    for opt in optimizers:
        for st in opt.state.values():
            tensors += [v for v in st.values() if torch.is_tensor(v)]
    tensors += list(extra)
    return tensors


def broadcast_module_state(modules: Iterable[torch.nn.Module], src: int = 0,
                           *, optimizers: Iterable = (),
                           extra: Iterable[torch.Tensor] = ()) -> None:
    """Overwrite, in place, the parameters and buffers of ``modules`` (the
    spectral vectors among them), the state of ``optimizers`` and the
    ``extra`` tensors (the EMA) with rank ``src``'s: flat buffers of one
    dtype and device each, at most ``BUCKET_BYTES``. Tensors on another
    device than the first module's (the Adam step counters, kept on the
    host and equal on every rank) are left alone."""
    if not initialized():
        return
    modules = list(modules)
    device = next(iter(modules[0].state_dict().values())).device
    tensors = [t for t in _state_tensors(modules, optimizers, extra)
               if t.device == device]
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for dtype, group_all in by_dtype.items():
            itemsize = torch.empty((), dtype=dtype).element_size()
            for group in _buckets(group_all, itemsize):
                flat = torch.cat([t.reshape(-1) for t in group])
                dist.broadcast(flat, src)
                parts = flat.split([t.numel() for t in group])
                torch._foreach_copy_(
                    group, [p.view_as(t) for p, t in zip(parts, group)])


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` stacked along dim 0 in rank order (each rank
    passes the same shape): an ``all_reduce`` over a zero-filled buffer
    that holds this rank's rows at its offset, exact in any dtype."""
    if not initialized():
        return t
    n = t.shape[0]
    out = t.new_zeros((world() * n, *t.shape[1:]))
    out[rank() * n:(rank() + 1) * n] = t
    dist.all_reduce(out)
    return out


def reduce_metrics(metrics: dict, average: bool = True) -> dict[str, float]:
    """Metric values (0-d tensors or floats, the same keys on every rank)
    as floats: their mean over ranks, or with ``average=False`` their
    sum. With no group, each value as it is."""
    if not initialized() or not metrics:
        return {k: float(v) for k, v in metrics.items()}
    device = _host_device()
    vals = torch.stack([torch.as_tensor(v, dtype=torch.float64).to(device)
                        for v in metrics.values()])
    dist.all_reduce(vals)
    if average:
        vals /= world()
    return dict(zip(metrics, vals.tolist()))
