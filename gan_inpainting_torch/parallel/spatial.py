"""The mesh's spatial axis: every activation split into row bands over a
group of members, in serving and in training.

The JAX package shards image rows over the mesh's ``spatial`` axis and
lets GSPMD insert the halo exchange every conv window needs at a band
boundary, and the transposes of those exchanges in the backward;
contextual attention gathers the key side explicitly
(gan_inpainting_tpu/ops/contextual_attention.py ``_spatial_attention``).
The port does both by hand: member ``i`` of a group of ``n`` holds rows
``[i·h, (i+1)·h)`` of every (B, n·h, W, C) activation, and

* :meth:`~SpatialGroup.halo` gives a conv its band with the rows above
  and below it, taken from as many neighbours as the window needs, zeros
  beyond the map (TF-SAME's zeros);
* :meth:`~SpatialGroup.gather_rows` gives attention the whole map;
* :meth:`~SpatialGroup.add_spill` adds the rows a band's overlap-add
  spills past its edges into the neighbours' bands (the counterpart of
  the JAX package's ``psum_scatter``);
* :meth:`~SpatialGroup.reduce_rows` is the reduce-scatter: this member's
  band of the sum of every member's whole map;
* :meth:`~SpatialGroup.all_reduce_` sums a tensor over the members (a
  loss's partial sums, a Gram matrix's band sums).

Two kinds of group hold them. A :class:`ThreadSpatialGroup` is one thread
per member in one process, on devices of their own (devices may repeat):
each exchange is one :class:`~gan_inpainting_torch.parallel.sharding.
_Exchange` round (post, barrier, peer copies of the needed rows onto the
member's device, barrier); serving over a group (infer/inpaint.py) uses
it. A :class:`ProcessSpatialGroup` is ranks of a ``torch.distributed``
group, as ``torchrun`` launches them for training: it uses
``all_reduce`` alone, which NCCL takes between cards and gloo takes on
CUDA tensors too (staged through the host), so two gloo ranks sharing one
card run the n-card code. Each of its exchanges is a zero-filled
``all_reduce``: every member writes the rows the others need from it at
its own offset of a buffer of zeros, and the sum, exact in every dtype,
holds them all; the halo posts only each band's edge rows.

Every member calls the same exchanges in the same order, each on a band
of the same height; members at the map's edges take part as the others
do (their rows beyond the map are zeros). Each exchange counts itself
and its bytes into ``sharding.counts``: for a thread group the bytes a
member took from the others, for a process group the bytes of the
buffer it all-reduced.

Gradients. The module functions :func:`halo`, :func:`gather_rows`,
:func:`add_spill`, :func:`reduce_rows` and :func:`group_sum` are the
exchanges as autograd functions over either kind of group, each the
other's transpose: the backward of a halo adds the halo rows' gradients
back onto their owners' bands (``add_spill`` with ``up, down = lo,
hi``), the backward of ``add_spill`` is a halo, the backward of
``gather_rows`` is ``reduce_rows`` (JAX's ``psum_scatter`` transpose)
and back, and a group sum's is a group sum. Each backward calls the other
function, so a second derivative (the lazy R1 penalty's double backward
through a discriminator on bands) goes through the exchanges too. A loss
over bands is a partial sum on each member, so every member's backward
ends with the gradient of the group's total, and a replicated weight's
gradient is the sum of the members' (parallel/sharding.py).

:func:`row_bands` puts the layers of a module on the bands of a group for
the length of a ``with`` block (the train step's choice per batch).
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from gan_inpainting_torch.parallel.sharding import _count, _Exchange


class SpatialGroup:
    """Member ``index`` of a spatial group of ``size`` members. Every
    member calls each method at the same point with a tensor of the same
    shape. The methods carry no gradient: the module functions do."""

    def __init__(self, index: int, size: int):
        self.index, self.size = index, size

    def halo(self, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """This member's band (B, h, W, C) with ``lo`` rows above and
        ``hi`` below: (B, lo + h + hi, W, C). Rows outside the map are
        zeros; a halo taller than a band takes rows from several
        neighbours."""
        raise NotImplementedError

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The whole map: every member's band, in member order."""
        raise NotImplementedError

    def add_spill(self, ext: torch.Tensor, up: int,
                  down: int) -> torch.Tensor:
        """``ext`` holds sums onto this member's band with ``up`` rows
        above it and ``down`` below, (B, up + h + down, W, C); returns the
        band (B, h, W, C): its own rows, then what the other members'
        ``ext`` put onto them added in member order. Rows beyond the map
        are dropped."""
        raise NotImplementedError

    def reduce_rows(self, g: torch.Tensor) -> torch.Tensor:
        """``g`` a whole map (B, n·h, W, C) on every member; returns this
        member's band of their sum."""
        raise NotImplementedError

    def all_reduce_(self, t: torch.Tensor) -> None:
        """Sum ``t`` over the members, in place."""
        raise NotImplementedError


class ThreadSpatialGroup(SpatialGroup):
    """Member ``index`` of a spatial group of ``size`` threads that share
    one :class:`_Exchange`. A member that fails calls :meth:`abort`, so
    the others raise instead of waiting; the caller calls :meth:`reset`
    once every member has returned."""

    def __init__(self, exchange: _Exchange, index: int):
        super().__init__(index, len(exchange.slots))
        self.exchange = exchange

    @classmethod
    def members(cls, n: int, timeout: float = 600.0) -> list:
        ex = _Exchange(n, timeout)
        return [cls(ex, i) for i in range(n)]

    def abort(self) -> None:
        self.exchange.abort()

    def reset(self) -> None:
        self.exchange.reset()

    def _rows(self, slots, x: torch.Tensor, start: int, stop: int):
        """Global rows [start, stop) of the map whose bands are ``slots``
        (each ``x``'s height), zeros outside it, on ``x``'s device; and the
        bytes taken from the other members."""
        bh, n = x.shape[1], self.size
        parts, taken, r = [], 0, start
        if r < 0:                       # above the map (stop > 0 here)
            parts.append(x.new_zeros((x.shape[0], -r, *x.shape[2:])))
            r = 0
        while r < min(stop, n * bh):
            m, off = divmod(r, bh)
            k = min(bh - off, stop - r)
            part = slots[m][:, off:off + k]
            if m != self.index:
                part = part.to(x.device)
                taken += part.numel() * part.element_size()
            parts.append(part)
            r += k
        if stop > r:
            parts.append(x.new_zeros((x.shape[0], stop - r, *x.shape[2:])))
        out = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
        return out, taken

    def halo(self, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        if lo == 0 and hi == 0:
            return x
        bh = x.shape[1]
        start = self.index * bh - lo

        def assemble(slots):
            return self._rows(slots, x, start, start + lo + bh + hi)

        out, taken = self.exchange.combine(self.index, x, assemble)
        _count("halo_exchanges")
        _count("halo_bytes", taken)
        return out

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        n, bh = self.size, x.shape[1]
        out, taken = self.exchange.combine(
            self.index, x, lambda slots: self._rows(slots, x, 0, n * bh))
        _count("row_gathers")
        _count("row_gather_bytes", taken)
        return out

    def add_spill(self, ext: torch.Tensor, up: int,
                  down: int) -> torch.Tensor:
        bh = ext.shape[1] - up - down
        lo = self.index * bh

        def total(slots):
            acc = ext[:, up:up + bh].clone()
            taken = 0
            for m, s in enumerate(slots):
                s0 = m * bh - up                 # global row of s[:, 0]
                a, b = max(s0, lo), min(s0 + s.shape[1], lo + bh)
                if m == self.index or a >= b:
                    continue
                part = s[:, a - s0:b - s0].to(ext.device)
                acc[:, a - lo:b - lo] += part
                taken += part.numel() * part.element_size()
            return acc, taken

        out, taken = self.exchange.combine(self.index, ext, total)
        _count("spill_adds")
        _count("spill_bytes", taken)
        return out

    def _sum(self, t: torch.Tensor, rows: slice | None):
        """Every member's ``t`` (its ``rows``), summed in member order on
        this member's device, and the bytes taken from the others."""
        def total(slots):
            acc, taken = None, 0
            for m, s in enumerate(slots):
                part = s if rows is None else s[:, rows]
                if m != self.index:
                    part = part.to(t.device)
                    taken += part.numel() * part.element_size()
                acc = part.clone() if acc is None else acc.add_(part)
            return acc, taken

        return self.exchange.combine(self.index, t, total)

    def reduce_rows(self, g: torch.Tensor) -> torch.Tensor:
        bh = g.shape[1] // self.size
        out, taken = self._sum(g, slice(self.index * bh,
                                        (self.index + 1) * bh))
        _count("row_reduces")
        _count("row_reduce_bytes", taken)
        return out

    def all_reduce_(self, t: torch.Tensor) -> None:
        out, taken = self._sum(t, None)
        t.copy_(out)
        _count("band_sums")
        _count("band_sum_bytes", taken)


class ProcessSpatialGroup(SpatialGroup):
    """The spatial group of ranks: a ``torch.distributed`` group whose
    member ``index`` is the group's rank ``index``. Every exchange is one
    ``all_reduce`` of a buffer that is zeros except where each member
    wrote its own rows (module docstring)."""

    def __init__(self, group, index: int, size: int):
        super().__init__(index, size)
        self.group = group

    def _all_reduce(self, buf: torch.Tensor, name: str) -> torch.Tensor:
        dist.all_reduce(buf, group=self.group)
        _count(f"{name}_bytes", buf.numel() * buf.element_size())
        return buf

    def halo(self, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        if lo == 0 and hi == 0:
            return x
        n, i, bh = self.size, self.index, x.shape[1]
        # each member posts its first `a` rows (the `hi` halos of the
        # members above it need no more) and its last `b` (the `lo` ones)
        a, b = min(bh, hi), min(bh, lo)
        buf = x.new_zeros((n, x.shape[0], a + b, *x.shape[2:]))
        buf[i, :, :a] = x[:, :a]
        buf[i, :, a:] = x[:, bh - b:]
        self._all_reduce(buf, "halo")
        _count("halo_exchanges")
        parts = []
        r, stop = i * bh - lo, i * bh
        if r < 0:                       # above the map
            parts.append(x.new_zeros((x.shape[0], -r, *x.shape[2:])))
            r = 0
        while r < stop:                 # from the last rows of those above
            m, off = divmod(r, bh)
            k = min(bh - off, stop - r)
            j = a + off - (bh - b)
            parts.append(buf[m, :, j:j + k])
            r += k
        parts.append(x)
        r, stop = (i + 1) * bh, (i + 1) * bh + hi
        while r < min(stop, n * bh):    # from the first rows of those below
            m, off = divmod(r, bh)
            k = min(bh - off, stop - r)
            parts.append(buf[m, :, off:off + k])
            r += k
        if stop > r:                    # below the map
            parts.append(x.new_zeros((x.shape[0], stop - r, *x.shape[2:])))
        return torch.cat(parts, 1)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        n, (bsz, bh) = self.size, x.shape[:2]
        buf = x.new_zeros((bsz, n, bh, *x.shape[2:]))
        buf[:, self.index] = x
        self._all_reduce(buf, "row_gather")
        _count("row_gathers")
        return buf.reshape(bsz, n * bh, *x.shape[2:])

    def add_spill(self, ext: torch.Tensor, up: int,
                  down: int) -> torch.Tensor:
        n, i = self.size, self.index
        bh = ext.shape[1] - up - down
        # each member posts the rows it spills: `up` above, `down` below
        buf = ext.new_zeros((n, ext.shape[0], up + down, *ext.shape[2:]))
        buf[i, :, :up] = ext[:, :up]
        buf[i, :, up:] = ext[:, up + bh:]
        self._all_reduce(buf, "spill")
        _count("spill_adds")
        acc = ext[:, up:up + bh].clone()
        lo = i * bh
        for m in range(n):
            if m == i:
                continue
            # member m's spill above covers rows [m·bh − up, m·bh), below
            # [(m+1)·bh, (m+1)·bh + down)
            for s0, j0, k in ((m * bh - up, 0, up),
                              ((m + 1) * bh, up, down)):
                a, b = max(s0, lo), min(s0 + k, lo + bh)
                if a < b:
                    acc[:, a - lo:b - lo] += buf[m, :, j0 + a - s0:
                                                 j0 + b - s0]
        return acc

    def reduce_rows(self, g: torch.Tensor) -> torch.Tensor:
        bh = g.shape[1] // self.size
        buf = self._all_reduce(g.clone(memory_format=torch.contiguous_format),
                               "row_reduce")
        _count("row_reduces")
        return buf[:, self.index * bh:(self.index + 1) * bh].clone()

    def all_reduce_(self, t: torch.Tensor) -> None:
        self._all_reduce(t, "band_sum")
        _count("band_sums")


# ---------------------------------------------------------------------------
# the exchanges with gradients
# ---------------------------------------------------------------------------


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, lo, hi):
        ctx.args = (group, lo, hi)
        return group.halo(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        group, lo, hi = ctx.args
        return add_spill(g, group, lo, hi), None, None, None


class _AddSpill(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ext, group, up, down):
        ctx.args = (group, up, down)
        return group.add_spill(ext, up, down)

    @staticmethod
    def backward(ctx, g):
        group, up, down = ctx.args
        return halo(g, group, up, down), None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.gather_rows(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_rows(g, ctx.group), None


class _ReduceRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, group):
        ctx.group = group
        return group.reduce_rows(g)

    @staticmethod
    def backward(ctx, gg):
        return gather_rows(gg, ctx.group), None


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        group.all_reduce_(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return group_sum(g, ctx.group), None


def halo(x: torch.Tensor, group: SpatialGroup, lo: int,
         hi: int) -> torch.Tensor:
    """:meth:`SpatialGroup.halo`, whose backward adds the halo rows'
    gradients onto their owners' bands."""
    if lo == 0 and hi == 0:
        return x
    return _Halo.apply(x.contiguous(), group, lo, hi)


def add_spill(ext: torch.Tensor, group: SpatialGroup, up: int,
              down: int) -> torch.Tensor:
    """:meth:`SpatialGroup.add_spill`, whose backward is a halo."""
    return _AddSpill.apply(ext.contiguous(), group, up, down)


def gather_rows(x: torch.Tensor, group: SpatialGroup) -> torch.Tensor:
    """:meth:`SpatialGroup.gather_rows`, whose backward is
    :func:`reduce_rows`."""
    return _GatherRows.apply(x.contiguous(), group)


def reduce_rows(g: torch.Tensor, group: SpatialGroup) -> torch.Tensor:
    """:meth:`SpatialGroup.reduce_rows`, whose backward is
    :func:`gather_rows`."""
    return _ReduceRows.apply(g.contiguous(), group)


def group_sum(t: torch.Tensor, group: SpatialGroup) -> torch.Tensor:
    """``t`` summed over the members (a new tensor); its backward is the
    group sum of the gradients."""
    return _GroupSum.apply(t, group)


def splits(rows: int, n: int, need: int = 4) -> bool:
    """Whether a map of ``rows`` rows splits into ``n > 1`` row bands of a
    multiple of ``need`` rows each. Every layer that halves the rows asks
    for even bands at its input: the generators' two stride-2 levels and
    their ``::4`` mask slices ask for 4 (the default); a train step's
    discriminator and VGG trunk ask for more (train/step.py)."""
    return n > 1 and rows % (n * need) == 0


def band(t: torch.Tensor, group: SpatialGroup | None) -> torch.Tensor:
    """This member's row band of a whole (B, H, …) tensor, contiguous
    (``t`` itself without a group)."""
    if group is None:
        return t
    h = t.shape[1] // group.size
    return t[:, group.index * h:(group.index + 1) * h].contiguous()


@contextlib.contextmanager
def row_bands(group: SpatialGroup | None, *modules: torch.nn.Module):
    """Within the block every layer of ``modules`` that takes a row band
    (each with a ``spatial_group`` attribute: the generators' convs and
    attention, the discriminator's and the VGG trunk's convs) runs on this
    member's band of ``group``, or on the whole map with ``None``; their
    groups are restored on leaving it."""
    layers = [m for module in modules for m in module.modules()
              if hasattr(m, "spatial_group")]
    saved = [m.spatial_group for m in layers]
    for m in layers:
        m.spatial_group = group
    try:
        yield
    finally:
        for m, g in zip(layers, saved):
            m.spatial_group = g
