"""The TMA boxes that the fused backward's producers request
(csrc/contextual_attention_bwd.cu ``scores_kernel``, ``products_kernel``)
against the tap slices that the mirror reads (``_tap``).

``tap_box`` is the producers' index arithmetic written in Python: a box of
the 4-D tensor map (C, ws + 2, hs + 2, B·r²) at the tap's shifted cell
origin. Each box is cut out of the maps here exactly as TMA would cut it
and must equal the same cells and channels of ``_tap``: 128-cell blocks
(the score tiles' A and B), 64-cell stages (the products' B) and their
shares over a cluster of 2 (64 and 32 cells), at ws 32 (4 map rows per 128
cells) and ws 64 (2 rows), for every Q/K and V/``do`` tap.
"""

import numpy as np
import pytest
import torch

from gan_inpainting_torch.ops.kernels.fused_attention_bwd import (
    TILE,
    _tap,
    tap_box,
    v_tap_geometry,
)


def _cut(maps, origin, box):
    """The box TMA copies out of maps (B, r, r, hs+2, ws+2, C), rows of
    cells in cell order × 64 channels; channels from C on are zeros (the
    out-of-bounds fill)."""
    b, r, _, hp, wp, c = maps.shape
    (ch, x, y, plane), (width, bw, bh, depth) = origin, box
    assert depth == 1 and width == 64 and 0 <= ch < c
    m4 = torch.nn.functional.pad(maps.reshape(b * r * r, hp, wp, c),
                                 (0, width))
    assert 0 <= x and x + bw <= wp and 0 <= y and y + bh <= hp
    return m4[plane, y:y + bh, x:x + bw, ch:ch + width].reshape(bh * bw, width)


def _check_boxes(ws, hs, cells, c):
    """Every box of every tap, sample, cell block and unit against the
    mirror's tap slice, zero-padded to whole units."""
    rate, bsz = 2, 2
    rng = np.random.default_rng(ws + cells)
    maps = torch.from_numpy(rng.standard_normal(
        (bsz, rate, rate, hs + 2, ws + 2, c)).astype(np.float32))
    lk = hs * ws
    units = -(-c // 64)
    kinds = [("qk", t, (0, 0, t // 3, t % 3)) for t in range(9)] + [
        ("v", t, g) for t, g in enumerate(v_tap_geometry(rate))]
    checked = 0
    for kind, tap, geo in kinds:
        want = torch.nn.functional.pad(_tap(maps, *geo, hs, ws),
                                       (0, units * 64 - c))   # (B, L, ·)
        for sample in range(bsz):
            for cell0 in range(0, lk, cells):
                for unit in range(units):
                    origin, box = tap_box(kind, tap, cell0, cells, ws, rate,
                                          sample, unit)
                    assert box[1] * box[2] == cells
                    got = _cut(maps, origin, box)
                    ref = want[sample, cell0:cell0 + cells,
                               unit * 64:(unit + 1) * 64]
                    assert torch.equal(got, ref), (kind, tap, cell0, unit)
                    checked += 1
    assert checked == 25 * bsz * (lk // cells) * units


@pytest.mark.parametrize("ws,hs", [(32, 8), (64, 4)])
@pytest.mark.parametrize("cells", [TILE, TILE // 2, TILE // 4])
def test_producer_boxes_are_the_mirror_taps(ws, hs, cells):
    _check_boxes(ws, hs, cells, 128)


# the published width's C 96: two boxes a tap, the second from channel 64,
# 64 wide, its last 32 channels zeros
@pytest.mark.parametrize("ws,hs", [(32, 8), (64, 4)])
@pytest.mark.parametrize("cells", [TILE, TILE // 2, TILE // 4])
def test_producer_boxes_reach_past_a_ragged_width(ws, hs, cells):
    (ch, *_), (width, *_) = tap_box("qk", 4, 0, cells, ws, 2, 1, 1)
    assert (ch, width) == (64, 64)
    (ch, *_), (width, *_) = tap_box("v", 15, 0, cells, ws, 2, 0, 1)
    assert (ch, width) == (64, 64)
    _check_boxes(ws, hs, cells, 96)
