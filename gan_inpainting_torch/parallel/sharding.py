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

The model axis (``train.mesh.model`` = n, ``model.tp_shard``): the n ranks
of a model group hold the same whole state and train the same batch
slice, and each sharded layer (models/layers.py ``InpaintConv``) computes
only its member's slice of the output channels from the whole input,
then :func:`gather_channels` concatenates the slices in member order, as
GSPMD's gathers do in the JAX package. The gradient rules, Megatron's:
the gather's backward takes the member's own channels; the input of a
sharded layer passes through :func:`reduce_input_grad`, the identity
whose backward sums the members' partial input gradients; a sliced
weight's gradient is nonzero on its member's rows only, so the model
group's sum is the whole gradient, exactly. The members compute the
replicated parts (the discriminator, attention, the heads) each for
itself, and on a card cuDNN picks its algorithms per process and some of
them add in a nondeterministic order, so those parts may differ between
members in their last bits: :func:`reduce_over_model_` therefore sums the
sliced weights' gradients and averages every other gradient over the
model group, so every member applies the same update.

The spatial axis (``train.mesh.spatial`` = n, parallel/spatial.py): the
n ranks of a spatial group train the same batch slice, each on one row
band of every activation, and each member's losses are its band's
partial sums over the whole map's normalizers. A replicated weight's
gradient is then the **sum** over the spatial group, since each member
holds the part its band contributes (where the step runs unsharded, at a
size some layer cannot split into bands, every member holds it whole and
the group averages instead).

Then comes the mean over the data axis: :func:`all_reduce_mean_` sums the
gradients over the ranks of this model index (every data and spatial
index) in one collective and divides by the data axis (by data ×
spatial where the step ran unsharded); :func:`mean_over_ranks` takes a
loss normalizer's sum over the spatial group and its mean over the data
group, the ranks of this model and spatial index (the world without
model and spatial axes). :func:`all_gather_rows` and
:func:`reduce_metrics` take the values of model index 0 and spatial
index 0 of each data index, so every rank returns the same numbers.
:func:`use_mesh` makes every axis's groups, on every rank in the same
order. A model group in one process, one thread per member on cards of
its own (or sharing one), is a :class:`ThreadModelGroup`: serving over a
group of cards (infer/inpaint.py) exchanges the slices by peer copies,
with no ``torch.distributed``; the spatial axis's thread groups sit on
the same :class:`_Exchange`.

Only ``all_reduce``, ``broadcast`` and ``barrier`` are used. NCCL takes
them between cards, and gloo takes them on CUDA tensors too (staged
through the host), so two gloo ranks sharing one card run the same code
an n-card NCCL run does: that is how a one-card machine checks it. A
gather is an ``all_reduce`` over a zero-filled buffer that holds this
rank's part at its offset (:func:`all_gather_rows`, and the channel
gather), which is exact in every dtype; it moves n times the bytes of an
``all_gather``.

With no process group initialized every function is the identity and
issues no collective, so a single process computes what it always did. In
a group of one each still issues its collective, whose result equals its
input. ``counts`` counts the gradient reduces (``all_reduce_mean_``, the
run's record logs it as ``grad_all_reduces``), the channel gathers and the
bytes of their buffers, the input-gradient reduces and the model group's
gradient reduces, the spatial axis's exchanges and their bytes, the
forwards and train steps that ran unsharded on a spatial group, and the
blocking copies between host and device in the batch build, the train
step and ``Inpainter``'s serve call, with their bytes (``host_syncs``,
``host_sync_bytes``, utils/spans.py).
"""

from __future__ import annotations

import threading
from typing import Iterable, NamedTuple, Sequence

import torch
import torch.distributed as dist

from gan_inpainting_torch.parallel import multihost
from gan_inpainting_torch.parallel.mesh import MeshConfig, train_mesh
from gan_inpainting_torch.parallel.multihost import initialized, world

BUCKET_BYTES = 64 << 20           # largest flat buffer per collective

counts: dict[str, int] = {"all_reduce_mean_": 0, "channel_gathers": 0,
                          "channel_gather_bytes": 0,
                          "input_grad_all_reduces": 0,
                          "model_grad_reduces": 0,
                          # the spatial axis (parallel/spatial.py): bytes
                          # each thread member takes from the others, the
                          # buffer bytes each rank all-reduces
                          "halo_exchanges": 0, "halo_bytes": 0,
                          "row_gathers": 0, "row_gather_bytes": 0,
                          "spill_adds": 0, "spill_bytes": 0,
                          "row_reduces": 0, "row_reduce_bytes": 0,
                          "band_sums": 0, "band_sum_bytes": 0,
                          "unsharded_forwards": 0, "unsharded_steps": 0,
                          # blocking host <-> device copies and their
                          # bytes (utils/spans.py ``transfer``)
                          "host_syncs": 0, "host_sync_bytes": 0}
_counts_lock = threading.Lock()   # the members of a thread group


def _count(name: str, n: int = 1) -> None:
    with _counts_lock:
        counts[name] += n


# ---------------------------------------------------------------------------
# the axes' groups
# ---------------------------------------------------------------------------


class ModelGroup:
    """One model group: member ``index`` of ``size``. :meth:`gather`
    concatenates every member's tensor along the last axis in member
    order; :meth:`all_reduce_` sums every member's tensor into each, in
    place. Every member calls both at the same points, in the same
    order."""

    def __init__(self, index: int, size: int):
        self.index, self.size = index, size

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def all_reduce_(self, t: torch.Tensor) -> None:
        raise NotImplementedError


class ProcessModelGroup(ModelGroup):
    """The model group of ranks: a ``torch.distributed`` group."""

    def __init__(self, group, index: int, size: int):
        super().__init__(index, size)
        self.group = group

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        # the zero-filled all_reduce: exact, and what gloo takes on a card
        c = t.shape[-1]
        out = t.new_zeros((*t.shape[:-1], c * self.size))
        out[..., self.index * c:(self.index + 1) * c] = t
        dist.all_reduce(out, group=self.group)
        _count("channel_gather_bytes", out.numel() * out.element_size())
        return out

    def all_reduce_(self, t: torch.Tensor) -> None:
        dist.all_reduce(t, group=self.group)


class _Exchange:
    """The slots and barrier of a group of threads: :meth:`combine` posts
    a member's tensor, waits for every member, applies ``fn`` to every
    member's post and waits again, so no member overwrites a slot another
    still reads. The barrier's ``timeout`` (seconds) bounds a wait;
    :meth:`abort` releases the waiting members with an error."""

    def __init__(self, n: int, timeout: float):
        self.slots: list = [None] * n
        self.barrier = threading.Barrier(n, timeout=timeout)

    def combine(self, index: int, t, fn):
        self.slots[index] = t
        self.barrier.wait()
        out = fn(self.slots)
        self.barrier.wait()
        return out

    def abort(self) -> None:
        self.barrier.abort()

    def reset(self) -> None:
        self.slots[:] = [None] * len(self.slots)
        self.barrier.reset()


class ThreadModelGroup(ModelGroup):
    """A model group of threads in one process, member ``index`` on its
    own device (devices may repeat): each exchange posts the member's
    tensor, waits for every member, combines the posted tensors on its
    own device (a peer copy and a ``cat``, or a sum in member order) and
    waits again, so no member overwrites a slot another still reads. The
    barrier's ``timeout`` (seconds) bounds a wait; a member that fails
    calls :meth:`abort`, so the others raise instead of waiting, and the
    caller calls :meth:`reset` once every member has returned."""

    def __init__(self, exchange: _Exchange, index: int):
        super().__init__(index, len(exchange.slots))
        self.exchange = exchange

    @classmethod
    def members(cls, n: int, timeout: float = 600.0) -> list:
        ex = _Exchange(n, timeout)
        return [cls(ex, i) for i in range(n)]

    def _combine(self, t: torch.Tensor, combine):
        return self.exchange.combine(
            self.index, t, lambda slots: combine([s.to(t.device)
                                                   for s in slots]))

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        out = self._combine(t, lambda parts: torch.cat(parts, -1))
        _count("channel_gather_bytes", out.numel() * out.element_size())
        return out

    def all_reduce_(self, t: torch.Tensor) -> None:
        def total(parts):
            acc = parts[0].clone()
            for p in parts[1:]:
                acc += p
            return acc

        t.copy_(self._combine(t, total))

    def abort(self) -> None:
        self.exchange.abort()

    def reset(self) -> None:
        self.exchange.reset()


class _Axes(NamedTuple):
    world_group: object           # the process group the axes were made in
    model: int
    spatial: int
    data_group: object            # this model and spatial index; None: world
    grad_group: object            # this model index; None: the world
    model_group: ModelGroup | None
    spatial_group: object         # a ProcessSpatialGroup, or None


_axes: _Axes | None = None        # this process's, made by use_mesh


def use_mesh(config: MeshConfig) -> ModelGroup | None:
    """Place this rank in ``config``'s training mesh over the ranks (the
    checks of ``train_mesh``) and make the process groups of every axis,
    on every rank in the same order; returns this rank's model group, or
    None without a model axis (:func:`spatial_group` gives its spatial
    group). Without a process group: None, and nothing changes. The
    groups are made once per process group and axis sizes."""
    global _axes
    if not initialized():
        return None
    mesh = train_mesh(config, world())
    multihost.set_axes(mesh.model, mesh.spatial)
    default = dist.distributed_c10d._get_default_group()
    if (_axes is None or _axes.world_group is not default
            or (_axes.model, _axes.spatial) != (mesh.model, mesh.spatial)):
        from gan_inpainting_torch.parallel.spatial import ProcessSpatialGroup

        m_n, s_n, d_n = mesh.model, mesh.spatial, mesh.data
        d_i, m_i, s_i = (multihost.data_index(), multihost.model_index(),
                         multihost.spatial_index())

        def rank_of(d, m, s):
            return (d * m_n + m) * s_n + s

        data_group = grad_group = model_group = spatial = None
        if s_n > 1:
            for d in range(d_n):
                for m in range(m_n):
                    g = dist.new_group([rank_of(d, m, s)
                                        for s in range(s_n)])
                    if (d, m) == (d_i, m_i):
                        spatial = ProcessSpatialGroup(g, s_i, s_n)
        if m_n > 1:
            for d in range(d_n):
                for s in range(s_n):
                    g = dist.new_group([rank_of(d, m, s)
                                        for m in range(m_n)])
                    if (d, s) == (d_i, s_i):
                        model_group = ProcessModelGroup(g, m_i, m_n)
        if m_n * s_n > 1:
            for m in range(m_n):
                for s in range(s_n):
                    g = dist.new_group([rank_of(d, m, s)
                                        for d in range(d_n)])
                    if (m, s) == (m_i, s_i):
                        data_group = g
        if m_n > 1 and s_n > 1:
            for m in range(m_n):
                g = dist.new_group([rank_of(d, m, s) for d in range(d_n)
                                    for s in range(s_n)])
                if m == m_i:
                    grad_group = g
        elif m_n > 1:
            grad_group = data_group     # the ranks of this model index
        _axes = _Axes(default, m_n, s_n, data_group, grad_group,
                      model_group, spatial)
    return _axes.model_group


def model_group() -> ModelGroup | None:
    """This rank's model group (:func:`use_mesh`), or None."""
    return _axes.model_group if initialized() and _axes else None


def spatial_group():
    """This rank's spatial group (a ``ProcessSpatialGroup``, made by
    :func:`use_mesh`), or None without a spatial axis."""
    return _axes.spatial_group if initialized() and _axes else None


def _data_group():
    """The data axis's group: the ranks of this model and spatial index
    (None, the world, without model and spatial axes)."""
    return _axes.data_group if _axes else None


# ---------------------------------------------------------------------------
# the model axis's autograd collectives
# ---------------------------------------------------------------------------


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return group.gather(t)

    @staticmethod
    def backward(ctx, g):
        # the upstream gradient is the same on every member: take ours
        group = ctx.group
        c = g.shape[-1] // group.size
        return g[..., group.index * c:(group.index + 1) * c], None


class _ReduceInputGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        ctx.group.all_reduce_(g)
        _count("input_grad_all_reduces")
        return g, None


def gather_channels(t: torch.Tensor,
                    group: ModelGroup | None) -> torch.Tensor:
    """(…, C) slices of the model group's members → (…, n·C), member
    order; its gradient is the member's own channels. ``t`` itself
    without a group."""
    if group is None:
        return t
    _count("channel_gathers")
    return _GatherChannels.apply(t, group)


def reduce_input_grad(x: torch.Tensor,
                      group: ModelGroup | None) -> torch.Tensor:
    """The identity, whose backward sums the gradient over the model group
    (the members' partial input gradients of a sharded layer)."""
    if group is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _ReduceInputGrad.apply(x, group)


def reduce_over_model_(tensors: Sequence[torch.Tensor],
                       sliced: Sequence[bool]) -> None:
    """Over this rank's model group, in place: the sum of each tensor
    marked ``sliced`` (a sliced weight's gradient, nonzero on its
    member's rows only: the sum is exact) and the mean of every other
    one (a replicated part's gradient, equal on every member up to the
    order of its sums). One flat float32 buffer per bucket; nothing
    without a model group."""
    group = model_group()
    if group is None or not tensors:
        return
    _count("model_grad_reduces")
    marks = dict(zip(map(id, tensors), sliced))
    for part in _buckets(tensors, 4):
        flat = torch.cat([t.reshape(-1).float() for t in part])
        group.all_reduce_(flat)
        pieces = list(flat.split([t.numel() for t in part]))
        for i, t in enumerate(part):
            if not marks[id(t)]:
                pieces[i] = pieces[i] / group.size
        torch._foreach_copy_(list(part),
                             [p.view_as(t) for p, t in zip(pieces, part)])


# ---------------------------------------------------------------------------
# the data axis
# ---------------------------------------------------------------------------


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


def all_reduce_mean_(tensors: Sequence[torch.Tensor],
                     bands_summed: bool = True) -> None:
    """Replace each tensor by its mean over the data axis, in place, of its
    sum over the spatial group (module docstring; with ``bands_summed``
    False, where every spatial member computed it whole, its mean over
    both): one ``all_reduce`` over the ranks of this model index per
    flat float32 bucket of at most ``BUCKET_BYTES``."""
    if not initialized():
        return
    _count("all_reduce_mean_")
    n = multihost.data_size()
    if not bands_summed:
        n *= multihost.spatial_size()
    group = _axes.grad_group if _axes else None
    for part in _buckets(tensors, 4):
        flat = torch.cat([t.reshape(-1).float() for t in part])
        dist.all_reduce(flat, group=group)
        flat /= n
        parts = flat.split([t.numel() for t in part])
        torch._foreach_copy_(list(part),
                             [p.view_as(t) for p, t in zip(parts, part)])


def mean_over_ranks(t: torch.Tensor, bands=None) -> torch.Tensor:
    """The mean of ``t`` over the data axis, outside autograd (a loss's
    normalizer), of its sum over ``bands`` first (a spatial group whose
    members hold the sums of their row bands); ``t`` itself with neither."""
    t = t.detach().clone()
    if bands is not None:
        bands.all_reduce_(t)
    if not initialized():
        return t
    dist.all_reduce(t, group=_data_group())
    return t / multihost.data_size()


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


def _speaks() -> bool:
    """Whether this rank's values stand for its data index: model index 0
    and spatial index 0 (each slice counts once)."""
    return multihost.model_index() == 0 and multihost.spatial_index() == 0


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every data index's ``t`` stacked along dim 0 in data order (each
    rank passes the same shape; of a model or spatial group, member 0's
    rows, so each slice counts once and every rank gets the same rows):
    an ``all_reduce`` of a zero-filled buffer that holds those rows at
    their offset, exact in any dtype."""
    if not initialized():
        return t
    n, i = t.shape[0], multihost.data_index()
    out = t.new_zeros((multihost.data_size() * n, *t.shape[1:]))
    if _speaks():
        out[i * n:(i + 1) * n] = t
    dist.all_reduce(out)
    return out


def reduce_metrics(metrics: dict, average: bool = True) -> dict[str, float]:
    """Metric values (0-d tensors or floats, the same keys on every rank)
    as floats: their mean over the data axis, or with ``average=False``
    their sum (of a model or spatial group, member 0's values, which are
    the group's: each slice counts once, and every rank gets the same
    numbers). With no group, each value as it is."""
    if not initialized() or not metrics:
        return {k: float(v) for k, v in metrics.items()}
    device = _host_device()
    vals = torch.stack([torch.as_tensor(v, dtype=torch.float64).to(device)
                        for v in metrics.values()])
    if not _speaks():
        vals.zero_()
    dist.all_reduce(vals)
    if average:
        vals /= multihost.data_size()
    return dict(zip(metrics, vals.tolist()))
