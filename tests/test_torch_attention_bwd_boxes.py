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
    cells in cell order × 64 channels."""
    b, r, _, hp, wp, c = maps.shape
    (ch, x, y, plane), (width, bw, bh, depth) = origin, box
    assert depth == 1 and width == 64
    m4 = maps.reshape(b * r * r, hp, wp, c)
    assert 0 <= x and x + bw <= wp and 0 <= y and y + bh <= hp
    return m4[plane, y:y + bh, x:x + bw, ch:ch + width].reshape(bh * bw, width)


@pytest.mark.parametrize("ws,hs", [(32, 8), (64, 4)])
@pytest.mark.parametrize("cells", [TILE, TILE // 2, TILE // 4])
def test_producer_boxes_are_the_mirror_taps(ws, hs, cells):
    rate, bsz, c = 2, 2, 128
    rng = np.random.default_rng(ws + cells)
    maps = torch.from_numpy(rng.standard_normal(
        (bsz, rate, rate, hs + 2, ws + 2, c)).astype(np.float32))
    lk = hs * ws
    kinds = [("qk", t, (0, 0, t // 3, t % 3)) for t in range(9)] + [
        ("v", t, g) for t, g in enumerate(v_tap_geometry(rate))]
    checked = 0
    for kind, tap, geo in kinds:
        want = _tap(maps, *geo, hs, ws)                    # (B, L, C)
        for sample in range(bsz):
            for cell0 in range(0, lk, cells):
                for unit in range(c // 64):
                    origin, box = tap_box(kind, tap, cell0, cells, ws, rate,
                                          sample, unit)
                    assert box[1] * box[2] == cells
                    got = _cut(maps, origin, box)
                    ref = want[sample, cell0:cell0 + cells,
                               unit * 64:(unit + 1) * 64]
                    assert torch.equal(got, ref), (kind, tap, cell0, unit)
                    checked += 1
    assert checked == 25 * bsz * (lk // cells) * (c // 64)
