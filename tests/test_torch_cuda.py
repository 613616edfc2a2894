"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA device. On a machine with a
card (no JAX needed, hence ``--noconftest``):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Float32 tolerance 2e-4 at these small shapes; bfloat16 runs the kernel on
bf16 inputs against the plain version in float32 on the same values, with
2^-7 of the largest input as the tolerance (weights and outputs rounded to
bf16). TF32 is off.
"""

import numpy as np
import pytest
import torch

from gan_inpainting_torch.ops import dispatch
from gan_inpainting_torch.ops.contextual_attention import (
    contextual_attention,
    contextual_attention_plain,
)
from gan_inpainting_torch.ops.kernels.fold import fold_taps, fold_taps_plain
from gan_inpainting_torch.ops.kernels.fused_attention import (
    _launch,
    _prepare,
    fused_attention_taps,
    fused_attention_taps_plain,
    plan,
)

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, b, h, w, c, device):
    rng = np.random.default_rng(seed)
    f = np.maximum(rng.standard_normal((b, h, w, c)), 0).astype(np.float32)
    hole = (rng.random((b, h, w, 1)) < 0.3).astype(np.float32)
    if b >= 3:
        hole[0], hole[1] = 0.0, 1.0      # no hole, all hole
    return (torch.from_numpy(f).to(device), torch.from_numpy(hole).to(device))


SHAPES = [
    (3, 16, 16, 8, 2),
    (2, 12, 20, 4, 2),      # non-square
    (1, 14, 14, 4, 2),      # Lk = 49: padded score rows
    (1, 16, 16, 4, 4),
    (1, 16, 16, 4, 1),
    (2, 64, 64, 192, 2),    # the 256² serve map, two images
]


@pytest.mark.parametrize("b,h,w,c,rate", SHAPES)
def test_attention_kernel_matches_plain(cuda, b, h, w, c, rate):
    f, hole = _case(b + h + c, b, h, w, c, cuda)
    got = fused_attention_taps(f, hole, rate=rate)
    want = fused_attention_taps_plain(f, hole, rate=rate)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    if b >= 3:
        assert got[1].abs().max().item() == 0.0
    fb = f.to(torch.bfloat16)
    got_b = fused_attention_taps(fb, hole, rate=rate)
    want_b = fused_attention_taps_plain(fb.float(), hole, rate=rate)
    tol = 2.0 ** -7 * fb.float().abs().max().item()
    assert (got_b.float() - want_b).abs().max().item() <= tol


@pytest.mark.parametrize("b,h,w,c,group,cluster", [
    (2, 64, 64, 192, 32, 1),     # 256² serve map
    (1, 64, 128, 128, 32, 2),    # Lk = 2048, non-square
    (2, 128, 128, 64, 32, 4),    # Lk = 4096, the 512² regime
    (1, 128, 256, 64, 32, 8),    # Lk = 8192
])
@pytest.mark.parametrize("variant", ["mma", "core"])
def test_both_variants_match_plain_in_bf16(cuda, b, h, w, c, group, cluster,
                                           variant):
    f, hole = _case(h + w + c, b, h, w, c, cuda)
    hole[0, : h // 2] = 1.0              # a large hole as well
    if b > 1:
        hole[1] = 1.0                    # and one with no valid key
    fb = f.to(torch.bfloat16)
    assert plan(h // 2, w // 2, c, torch.bfloat16) == ("mma", group, cluster)
    maps, bias, rnorm, (hs, ws) = _prepare(fb, hole, 3, 2)
    got = _launch(maps, bias, rnorm, hs, ws, 2, 10.0, variant=variant)
    want = fused_attention_taps_plain(fb.float(), hole)
    tol = 2.0 ** -7 * fb.float().abs().max().item()
    assert (got.float() - want).abs().max().item() <= tol


@pytest.mark.parametrize("b,h,w,c,rate", SHAPES)
def test_fold_kernel_matches_plain(cuda, b, h, w, c, rate):
    hs, ws = h // rate, w // rate
    rng = np.random.default_rng(h * w)
    taps = torch.from_numpy(rng.standard_normal(
        (b, 4 * rate * rate, hs * ws, c)).astype(np.float32)).to(cuda)
    torch.testing.assert_close(fold_taps(taps, hs, ws, rate),
                               fold_taps_plain(taps, hs, ws, rate),
                               rtol=1e-5, atol=1e-5)
    tb = taps.to(torch.bfloat16)
    got = fold_taps(tb, hs, ws, rate).float()
    want = fold_taps_plain(tb.float(), hs, ws, rate)
    assert (got - want).abs().max().item() <= 2.0 ** -7 * 4


def test_contextual_attention_on_cuda_uses_both_kernels(cuda):
    f, hole = _case(1, 3, 32, 32, 8, cuda)
    dispatch.reset_launches()
    got = contextual_attention(f, f, hole)
    assert dispatch.launches["contextual_attention_fused"] == 1
    assert dispatch.launches["fold_taps"] == 1
    torch.testing.assert_close(got, contextual_attention_plain(f, f, hole),
                               rtol=2e-4, atol=2e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    f, hole = _case(2, 1, 16, 16, 4, cuda)
    with pytest.raises(TypeError):
        fused_attention_taps(f.half(), hole)
    with pytest.raises(ValueError, match="ksize"):
        fused_attention_taps(f, hole, ksize=5)
    with pytest.raises(ValueError, match="C % 4"):
        fused_attention_taps(f[..., :3].contiguous(), hole)
    with pytest.raises(NotImplementedError):
        contextual_attention(f, f.clone(), hole)
    taps = torch.zeros(1, 16, 64, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fold_taps(taps.transpose(2, 3).contiguous().transpose(2, 3), 8, 8, 2)
