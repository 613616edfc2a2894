"""The mesh's spatial axis in serving: every activation split into row
bands over a group of threads.

The JAX package shards image rows over the mesh's ``spatial`` axis and
lets GSPMD insert the halo exchange every conv window needs at a band
boundary; contextual attention gathers the key side explicitly
(gan_inpainting_tpu/ops/contextual_attention.py ``_spatial_attention``).
The port does both by hand, in one process: member ``i`` of a
:class:`ThreadSpatialGroup` of ``n`` holds rows ``[i·h, (i+1)·h)`` of
every (B, n·h, W, C) activation, on a thread and a device of its own
(devices may repeat), and

* :meth:`~ThreadSpatialGroup.halo` gives a conv its band with the rows
  above and below it, taken from as many neighbours as the window needs,
  zeros beyond the map (TF-SAME's zeros);
* :meth:`~ThreadSpatialGroup.gather_rows` gives attention the whole map;
* :meth:`~ThreadSpatialGroup.add_spill` adds the rows a band's
  overlap-add spills past its edges into the neighbours' bands (the
  counterpart of the JAX package's ``psum_scatter``).

Every member calls the same exchanges in the same order, each on a band
of the same height. Each exchange is one :class:`~gan_inpainting_torch.
parallel.sharding._Exchange` round (post, barrier, peer copies of the
needed rows onto the member's device, barrier) and counts itself and the
bytes the member took from the others into ``sharding.counts``. A member
that fails calls :meth:`~ThreadSpatialGroup.abort`, so the others raise
instead of waiting; the caller calls :meth:`~ThreadSpatialGroup.reset`
once every member has returned.

Serving only: the exchanges carry no gradient, and raise where autograd
would record one (training over the axis is ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import torch

from gan_inpainting_torch.parallel.sharding import _count, _Exchange


def _refuse_grad(t: torch.Tensor) -> None:
    if torch.is_grad_enabled() and t.requires_grad:
        raise NotImplementedError(
            "the spatial axis's row exchanges carry no gradient: training "
            "over the spatial axis is ROADMAP Queue 1 item 3")


class ThreadSpatialGroup:
    """Member ``index`` of a spatial group of ``size`` threads that share
    one :class:`_Exchange`."""

    def __init__(self, exchange: _Exchange, index: int):
        self.exchange = exchange
        self.index, self.size = index, len(exchange.slots)

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
        """This member's band (B, h, W, C) with ``lo`` rows above and
        ``hi`` below: (B, lo + h + hi, W, C). Rows outside the map are
        zeros; a halo taller than a band takes rows from several
        neighbours."""
        _refuse_grad(x)
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
        """The whole map: every member's band, in member order."""
        _refuse_grad(x)
        n, bh = self.size, x.shape[1]
        out, taken = self.exchange.combine(
            self.index, x, lambda slots: self._rows(slots, x, 0, n * bh))
        _count("row_gathers")
        _count("row_gather_bytes", taken)
        return out

    def add_spill(self, ext: torch.Tensor, up: int,
                  down: int) -> torch.Tensor:
        """``ext`` holds sums onto this member's band with ``up`` rows
        above it and ``down`` below, (B, up + h + down, W, C); returns the
        band (B, h, W, C): its own rows, then what the other members'
        ``ext`` put onto them added in member order. Rows beyond the map
        are dropped."""
        _refuse_grad(ext)
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
