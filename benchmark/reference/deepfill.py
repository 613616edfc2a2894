"""Plain float32 DeepFill v2 (Yu et al., ICCV 2019, arXiv:1806.03589):
the coarse-to-fine gated-conv generator with contextual attention, the
PatchGAN discriminator and the free-form brush masks, NHWC.

The benchmark's yardstick: written with nothing but ``torch`` and
``torch.nn.functional``, run in float32 with TF32 off, and independent of
the program under test. Parameters are a flat ``{name: tensor}`` dict whose
names are the program's ``state_dict`` keys (``coarse.conv0.weight``, ...),
so the benchmark hands both sides the same tensors. The published model:
nearest 2x upsampling then a 3x3 conv in the decoder, TF-SAME padding,
ELU features gated by a sigmoid, tanh heads.

``q`` (optional, on every function that convolves or attends) rounds the
operands of each conv and of each attention product before it is taken:
:func:`fp8` gives the lower-precision control.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

NEG_INF = -1e9

# a layer: (features, kernel, stride, dilation, activation, upsample); a
# gated conv but for activation "none", the plain 3-feature output head


def encoder_specs(f: int) -> list[tuple]:
    return [(f, 5, 1, 1, "elu", False), (2 * f, 3, 2, 1, "elu", False),
            (2 * f, 3, 1, 1, "elu", False), (4 * f, 3, 2, 1, "elu", False),
            (4 * f, 3, 1, 1, "elu", False), (4 * f, 3, 1, 1, "elu", False)]


def dilation_specs(f: int) -> list[tuple]:
    return [(4 * f, 3, 1, d, "elu", False) for d in (2, 4, 8, 16)]


def decoder_specs(f: int) -> list[tuple]:
    return [(4 * f, 3, 1, 1, "elu", False), (4 * f, 3, 1, 1, "elu", False),
            (2 * f, 3, 1, 1, "elu", True), (2 * f, 3, 1, 1, "elu", False),
            (f, 3, 1, 1, "elu", True), (f // 2, 3, 1, 1, "elu", False),
            (3, 3, 1, 1, "none", False)]


def attn_enc_specs(f: int) -> list[tuple]:
    return [(f, 5, 1, 1, "elu", False), (2 * f, 3, 2, 1, "elu", False),
            (2 * f, 3, 1, 1, "elu", False), (4 * f, 3, 2, 1, "elu", False),
            (4 * f, 3, 1, 1, "relu", False)]


def generator_stacks(f: int) -> dict[str, tuple[int, list[tuple]]]:
    """Each stack of the generator: (input channels, layer specs)."""
    enc = encoder_specs(f) + dilation_specs(f)
    return {
        "coarse": (4, enc + decoder_specs(f)),
        "refine_conv": (4, enc),
        "refine_attn_enc": (4, attn_enc_specs(f)),
        "refine_attn_post": (4 * f, [(4 * f, 3, 1, 1, "elu", False)] * 2),
        "refine_dec": (8 * f, decoder_specs(f)),
    }


def generator_shapes(f: int) -> dict[str, tuple[tuple, int]]:
    """{parameter name: (shape, fan_in)} of the generator; a gated conv
    owns one conv of 2F outputs, the 3-feature heads are plain."""
    out = {}
    for stack, (cin, specs) in generator_stacks(f).items():
        for i, (feat, k, _, _, act, _) in enumerate(specs):
            cout = feat if act == "none" else 2 * feat
            out[f"{stack}.conv{i}.weight"] = ((cout, cin, k, k), cin * k * k)
            out[f"{stack}.conv{i}.bias"] = ((cout,), 0)
            cin = feat
    return out


def discriminator_specs(f: int, layers: int) -> list[tuple]:
    """(cin, cout, stride, activation) of each 5x5 conv, head last."""
    specs, cin = [], 4
    for i in range(layers):
        width = min(f * 2 ** i, 4 * f)
        specs.append((cin, width, 2, "leaky_relu"))
        cin = width
    specs.append((cin, 1, 1, "none"))
    return specs


def discriminator_shapes(f: int, layers: int) -> dict[str, tuple[tuple, int]]:
    out = {}
    specs = discriminator_specs(f, layers)
    for i, (cin, cout, _, _) in enumerate(specs):
        name = "head" if i == len(specs) - 1 else f"conv{i}"
        out[f"{name}.weight"] = ((cout, cin, 5, 5), cin * 25)
        out[f"{name}.bias"] = ((cout,), 0)
    return out


# ---------------------------------------------------------------------------
# Precision of the operands
# ---------------------------------------------------------------------------


def _round8(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``t`` rounded to a float8 format under a per-tensor scale that maps
    its largest magnitude to the format's largest, back in t's dtype."""
    scale = top / t.abs().amax().float().clamp(min=1e-30)
    return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    """Float8 training's rounding: e4m3 (largest 448) on the way forward,
    e5m2 (largest 57344) on the gradient coming back."""

    @staticmethod
    def forward(ctx, t):
        return _round8(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, 57344.0)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """An operand of a conv or an attention product in float8: e4m3
    forward, its gradient e5m2 (the usual float8 training recipe), each
    under a per-tensor scale."""
    return _Fp8.apply(t)


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matmuls and convs (the card would round float32
    operands to TF32 otherwise), and cuDNN's per-shape search off (its
    trials of float32 algorithms cost minutes at these shapes), restored
    after."""
    cudnn = torch.backends.cudnn
    old = (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32,
           cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn.allow_tf32 = cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32,
         cudnn.benchmark) = old


def _q(t, q):
    return t if q is None else q(t)


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------


def same_pads(size: int, window: int, stride: int) -> tuple[int, int]:
    """TF-SAME padding (lo, hi): the odd pixel on the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def conv(x, w, b, stride: int = 1, dilation: int = 1, q=None):
    """NHWC TF-SAME conv: x (B, H, W, Cin), w (Cout, Cin, k, k). A
    dilated conv is taken as an undilated one over the d x d phases of
    the padded map (space to batch: the same products and sums), which
    the card's float32 library runs far faster than a dilated kernel."""
    k = w.shape[2]
    eff = (k - 1) * dilation + 1
    ph = same_pads(x.shape[1], eff, stride)
    pw = same_pads(x.shape[2], eff, stride)
    xp = F.pad(_q(x, q), (0, 0, pw[0], pw[1], ph[0], ph[1]))
    bsz, hp, wp, cin = xp.shape
    d = dilation
    if d > 1 and stride == 1 and hp % d == 0 and wp % d == 0:
        phases = xp.reshape(bsz, hp // d, d, wp // d, d, cin).permute(
            0, 2, 4, 5, 1, 3).reshape(bsz * d * d, cin, hp // d, wp // d)
        y = F.conv2d(phases, _q(w, q), b)
        ho, wo = y.shape[2:]
        y = y.reshape(bsz, d, d, -1, ho, wo).permute(0, 4, 1, 5, 2, 3)
        return y.reshape(bsz, ho * d, wo * d, -1)
    y = F.conv2d(xp.permute(0, 3, 1, 2), _q(w, q), b, stride=stride,
                 dilation=dilation)
    return y.permute(0, 2, 3, 1)


def activation(x, name: str):
    if name == "elu":
        return F.elu(x)
    if name == "relu":
        return F.relu(x)
    if name == "leaky_relu":
        return F.leaky_relu(x, 0.2)
    return x


def upsample2x(x):
    return x.repeat_interleave(2, 1).repeat_interleave(2, 2)


def run_stack(params, prefix: str, specs, x, q=None):
    for i, (feat, _, stride, dil, act, up) in enumerate(specs):
        if up:
            x = upsample2x(x)
        y = conv(x, params[f"{prefix}.conv{i}.weight"],
                 params[f"{prefix}.conv{i}.bias"], stride, dil, q)
        if act == "none":
            x = y
        else:
            feats, gate = torch.chunk(y, 2, dim=-1)
            x = activation(feats, act) * torch.sigmoid(gate)
    return x


def downscale_mask_max(mask, rate: int):
    """Max over each rate x rate window of a (B, H, W, 1) hole mask."""
    y = F.max_pool2d(mask.permute(0, 3, 1, 2), rate, rate)
    return y.permute(0, 2, 3, 1)


def extract_patches(x, window: int, stride: int):
    """(B, H, W, C) -> (B, Ho, Wo, k, k, C), TF-SAME padded."""
    b, h, w, c = x.shape
    ph, pw = same_pads(h, window, stride), same_pads(w, window, stride)
    xp = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    ho = (xp.shape[1] - window) // stride + 1
    wo = (xp.shape[2] - window) // stride + 1
    parts = [xp[:, p:p + (ho - 1) * stride + 1:stride,
                r:r + (wo - 1) * stride + 1:stride, :]
             for p in range(window) for r in range(window)]
    return torch.stack(parts, dim=3).reshape(b, ho, wo, window, window, c)


def fold_patches(patches, stride: int, out_hw):
    """Overlap-add of (B, Ho, Wo, k, k, C) patches onto (B, H, W, C), and
    the (H, W, 1) overlap counts."""
    b, ho, wo, k, _, c = patches.shape
    h, w = out_hw
    ph, pw = same_pads(h, k, stride), same_pads(w, k, stride)
    hp, wp = h + ph[0] + ph[1], w + pw[0] + pw[1]
    out = patches.new_zeros((b, hp, wp, c))
    cnt = patches.new_zeros((hp, wp, 1))
    for p in range(k):
        for r in range(k):
            rs = slice(p, p + (ho - 1) * stride + 1, stride)
            cs = slice(r, r + (wo - 1) * stride + 1, stride)
            out[:, rs, cs, :] += patches[:, :, :, p, r, :]
            cnt[rs, cs, :] += 1
    return (out[:, ph[0]:ph[0] + h, pw[0]:pw[0] + w, :],
            cnt[ph[0]:ph[0] + h, pw[0]:pw[0] + w, :])


def key_validity(hole_s, ksize: int):
    """(B, hs, ws, 1) downscaled holes -> (B, hs*ws) bool: a key is valid
    iff its ksize window holds no hole cell (cells off the map are not
    holes)."""
    lo, hi = (ksize - 1) // 2, ksize // 2
    x = F.pad(hole_s.permute(0, 3, 1, 2), (lo, hi, lo, hi),
              value=float("-inf"))
    return (F.max_pool2d(x, ksize, 1) <= 0.0).reshape(hole_s.shape[0], -1)


def contextual_attention(x, hole, ksize: int = 3, rate: int = 2,
                         softmax_scale: float = 10.0, q=None):
    """Contextual attention of a map with itself (f = b = x): keys are the
    L2-normalized ksize patches of x at stride ``rate`` (norms floored at
    1e-4), queries the same patches unnormalized; keys touching the hole
    take a -1e9 bias and, after the softmax, a weight of 0; values are the
    (2 rate)^2 patches of x at stride ``rate``, overlap-added and divided
    by the overlap counts. ``hole`` is (B, H, W, 1) at x's resolution."""
    bsz, h, w, c = x.shape
    hs, ws = h // rate, w // rate
    v = extract_patches(x, 2 * rate, rate).reshape(bsz, hs * ws, -1)
    k_raw = extract_patches(x[:, ::rate, ::rate, :], ksize, 1)
    k_raw = k_raw.reshape(bsz, hs * ws, ksize * ksize * c)
    norm = torch.sqrt(torch.sum(k_raw * k_raw, -1, keepdim=True))
    k = k_raw / torch.clamp(norm, min=1e-4)
    valid = key_validity(downscale_mask_max(hole, rate), ksize)
    s = torch.matmul(_q(k_raw, q), _q(k, q).transpose(1, 2)) * softmax_scale
    s = s + torch.where(valid, 0.0, NEG_INF)[:, None, :]
    attn = torch.softmax(s, dim=-1) * valid[:, None, :].to(s.dtype)
    y = torch.matmul(_q(attn, q), _q(v, q))
    y = y.reshape(bsz, hs, ws, 2 * rate, 2 * rate, c)
    out, cnt = fold_patches(y, rate, (h, w))
    return out / torch.clamp(cnt, min=1.0)


def generator(params, masked, mask, f: int = 48, rate: int = 2, q=None,
              attention=contextual_attention):
    """(coarse, fine) images in [-1, 1] from the masked image (B, H, W, 3)
    in [-1, 1] and the hole mask (B, H, W, 1), 1 = hole."""
    stacks = generator_stacks(f)
    valid = 1.0 - mask
    x1 = run_stack(params, "coarse", stacks["coarse"][1],
                   torch.cat([masked, mask], -1), q)
    coarse = torch.tanh(x1)
    pasted = coarse * mask + masked * valid
    x2 = torch.cat([pasted, mask], -1)
    conv_branch = run_stack(params, "refine_conv", stacks["refine_conv"][1],
                            x2, q)
    xa = run_stack(params, "refine_attn_enc", stacks["refine_attn_enc"][1],
                   x2, q)
    xa = attention(xa, downscale_mask_max(mask, 4), rate=rate, q=q)
    xa = run_stack(params, "refine_attn_post",
                   stacks["refine_attn_post"][1], xa, q)
    x2 = run_stack(params, "refine_dec", stacks["refine_dec"][1],
                   torch.cat([conv_branch, xa], -1), q)
    return coarse, torch.tanh(x2)


def discriminator(params, image, mask, f: int = 64, layers: int = 4, q=None):
    """PatchGAN logit map (B, h, w, 1) of concat(image, mask)."""
    x = torch.cat([image, mask], -1)
    specs = discriminator_specs(f, layers)
    for i, (_, _, stride, act) in enumerate(specs):
        name = "head" if i == len(specs) - 1 else f"conv{i}"
        x = activation(conv(x, params[f"{name}.weight"],
                            params[f"{name}.bias"], stride, 1, q), act)
    return x


# ---------------------------------------------------------------------------
# Serving: uint8 in, uint8 out
# ---------------------------------------------------------------------------


def inpaint_u8(params, images_u8, masks, f: int = 48, q=None):
    """The served result: normalize, the generator, the composite on the
    raw uint8 input (known pixels unchanged), rounded to uint8 (half to
    even). images_u8 (B, H, W, 3) uint8, masks (B, H, W, 1) float 1 = hole."""
    image = images_u8.float() / 127.5 - 1.0
    _, fine = generator(params, image * (1.0 - masks), masks, f, q=q)
    u8 = torch.round(torch.clamp((fine + 1.0) * 127.5, 0.0, 255.0))
    return torch.where(masks <= 0.0, images_u8, u8.to(torch.uint8))


# ---------------------------------------------------------------------------
# Free-form masks (the DeepFill v2 brush walk as capsules)
# ---------------------------------------------------------------------------


def uniform(gen: torch.Generator, shape, low=0.0, high=1.0):
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
    return low + (high - low) * u


def sample_strokes(gen: torch.Generator, m: dict, height: int, width: int,
                   batch: int) -> dict:
    """Brush-walk parameters of ``batch`` masks, drawn on the CPU in this
    order: stroke counts, segment counts, starts, angles, lengths, widths.
    ``m`` holds max_strokes, max_segments, min_width, max_width, max_step."""
    v, k = m["max_strokes"], m["max_segments"]
    return {
        "n_strokes": torch.randint(1, v + 1, (batch,), generator=gen),
        "n_segs": torch.randint(1, k + 1, (batch, v), generator=gen),
        "starts": uniform(gen, (batch, v, 2))
        * torch.tensor([height, width], dtype=torch.float32),
        "angles": uniform(gen, (batch, v, k), 0.0, 2.0 * math.pi),
        "lengths": uniform(gen, (batch, v, k), 1.0, m["max_step"]),
        "widths": uniform(gen, (batch, v), m["min_width"], m["max_width"]),
    }


def rasterize(params: dict, height: int, width: int, device) -> torch.Tensor:
    """Capsules of the walk (angles alternate direction each segment,
    vertices clipped to the image) -> (B, H, W, 1) float32 in {0, 1}."""
    angles, lengths = params["angles"], params["lengths"]
    bsz, v, k = angles.shape
    angles = angles + torch.where(torch.arange(k) % 2 == 0, 0.0, math.pi)
    deltas = torch.stack([lengths * torch.sin(angles),
                          lengths * torch.cos(angles)], -1)
    starts = params["starts"][:, :, None, :]
    verts = torch.cat([starts, starts + torch.cumsum(deltas, 2)], 2)
    lim = torch.tensor([height - 1, width - 1], dtype=torch.float32)
    verts = torch.minimum(torch.clamp(verts, min=0.0), lim)
    a = verts[:, :, :-1].reshape(bsz, v * k, 2).to(device)
    b = verts[:, :, 1:].reshape(bsz, v * k, 2).to(device)
    w = params["widths"].repeat_interleave(k, 1).to(device)
    stroke = torch.arange(v).repeat_interleave(k)
    seg = torch.arange(k).repeat(v)
    valid = ((stroke[None] < params["n_strokes"][:, None])
             & (seg[None] < params["n_segs"][:, stroke])).to(device)
    ys = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    hit = torch.zeros((bsz, height, width), dtype=torch.bool, device=device)
    for i in range(a.shape[1]):
        ay, ax = a[:, i, 0, None, None], a[:, i, 1, None, None]
        dy_, dx_ = b[:, i, 0, None, None] - ay, b[:, i, 1, None, None] - ax
        len2 = torch.clamp(dy_ * dy_ + dx_ * dx_, min=1e-6)
        t = torch.clamp(((ys - ay) * dy_ + (xs - ax) * dx_) / len2, 0.0, 1.0)
        dy, dx = ys - (ay + t * dy_), xs - (ax + t * dx_)
        r = w[:, i, None, None] * 0.5
        hit |= (dy * dy + dx * dx <= r * r) & valid[:, i, None, None]
    return hit.float()[..., None]


def freeform_masks(gen: torch.Generator, m: dict, batch: int, size: int,
                   device) -> torch.Tensor:
    return rasterize(sample_strokes(gen, m, size, size, batch), size, size,
                     device)
