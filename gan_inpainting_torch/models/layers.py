"""Conv building block of the generators: plain, gated or partial conv,
NHWC.

Parameters are float32 ``weight`` (Cout, Cin, k, k) and ``bias`` (Cout,),
cast to the compute dtype per call; a gated conv owns one conv of 2F
outputs. ``backend`` (``model.kernel_backend``) picks, below the module
layer, between the library composition and the hand-written CUDA kernels of
gated and partial convs (ops/dispatch.py). ``pre_upsample`` fuses a
preceding nearest-2x upsample into the conv (ops/upsample_conv.py) and
``s2d`` evaluates a 5x5 stem conv in the space-to-depth cell domain
(ops/s2d_conv.py): same parameter, same math; neither goes through the
gated-conv kernels.

Given a ``model_group`` (parallel/sharding.py), the layer is sharded over
the mesh's model axis, as the JAX package's ``shard_channels`` shards its
output: member m of n computes output features ``[m·F/n, (m+1)·F/n)`` (a
gated conv also the matching gates, rows ``F + [m·F/n, (m+1)·F/n)`` of
its 2F) from the whole input and the whole, replicated parameters, and the
slices are gathered back to F channels in member order. Every conv kind
and rewrite takes the sliced weights as it takes whole ones. Where a
gradient is taken the slice is cut under autograd at every call (its
gradient is the whole parameter's, zero off the member's rows); otherwise
it is cut once per parameter version and kept, so that the gated-conv
kernels keep one packed copy of it.

Given a ``spatial_group`` (parallel/spatial.py), the layer takes one row
band of the map, as a device of the JAX package's spatial axis holds one
(GSPMD inserts the halo exchange there). Every conv kind, kernel and
rewrite runs unchanged: the band is widened by the rows its window needs
from the neighbours (:func:`~gan_inpainting_torch.parallel.spatial.halo`,
zeros beyond the map: TF-SAME's zeros; its backward adds the halo rows'
gradients back onto their owners), the op pads it TF-SAME as it pads a
whole map, and the output rows that belong to the band are kept
(:func:`band_form`). Per form, on a band of h rows:

* stride 1, window ``eff = (k − 1)·d + 1`` (the ``s2d`` stem and the
  discriminator's 5×5 head included): halo ``((eff − 1) // 2, eff //
  2)``, keep ``[lo, lo + h)``;
* stride 2 on an even band: the map's TF-SAME pad is ``(p, eff − 2 − p)``
  with ``p = (eff − 2) // 2``; the halo is ``p`` rows above and, below,
  ``eff − 2 − p`` rows or one more, whichever makes the op's own top pad
  of the widened band even, so its output rows fall on the map's: 3×3 (the generators)
  halo (0, 2), the op's pad (0, 1), keep the first h / 2; 5×5 (the
  discriminator) halo (1, 2), the op's pad (2, 2), keep rows
  ``[1, 1 + h / 2)``;
* ``pre_upsample``: halo (1, 1) at low resolution, keep output rows
  ``[2, 2 + 2h)``;
* partial convs halo ``valid`` as they halo ``x``; the window counts see
  zeros beyond the map, as TF-SAME's do.

Under both axes a member first takes its halo from its spatial peers
(the same model index), then computes its channel slice and gathers it
from its model peers (the same spatial index).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gan_inpainting_torch.ops.conv import conv2d
from gan_inpainting_torch.ops.gated_conv import (
    _activation,
    gated_conv,
    gated_epilogue,
)
from gan_inpainting_torch.ops.partial_conv import partial_conv
from gan_inpainting_torch.ops.s2d_conv import s2d_conv5x5_epilogue
from gan_inpainting_torch.ops.upsample_conv import upsample2x_conv2d_epilogue
from gan_inpainting_torch.parallel.sharding import (
    ModelGroup,
    gather_channels,
    reduce_input_grad,
)
from gan_inpainting_torch.parallel.spatial import SpatialGroup, halo


class InpaintConv(nn.Module):
    """forward(x, valid) -> (y, valid_out). ``valid`` (1 = known pixel) is
    threaded through the network for partial convs, which dilate it; plain
    and gated convs pass it on, stride-resized."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, conv_kind: str = "plain",
                 activation: str = "elu",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 pre_upsample: bool = False, s2d: bool = False,
                 backend: str = "auto", model_group: ModelGroup | None = None,
                 spatial_group: SpatialGroup | None = None,
                 name: str = "InpaintConv"):
        super().__init__()
        if conv_kind not in ("plain", "gated", "partial"):
            raise ValueError(f"unknown conv_kind {conv_kind!r}")
        rewritable = (conv_kind in ("plain", "gated") and stride == 1
                      and dilation == 1)
        if pre_upsample and not (rewritable and kernel_size == 3):
            raise ValueError("pre_upsample requires a plain/gated 3x3 "
                             "stride-1 undilated conv")
        if s2d and not (rewritable and kernel_size == 5):
            raise ValueError("s2d requires a plain/gated 5x5 stride-1 "
                             "undilated conv")
        self.kernel_size = kernel_size
        self.stride = stride
        self.dilation = dilation
        self.conv_kind = conv_kind
        self.activation = activation
        self.compute_dtype = compute_dtype
        self.pre_upsample = pre_upsample
        self.s2d = s2d
        self.backend = backend
        self.features = features
        if model_group is not None and features % model_group.size:
            raise ValueError(
                f"{name}: {features} output features do not split over a "
                f"model axis of {model_group.size} (model.tp_shard shards "
                "every conv whose features are a multiple of 8)")
        self.model_group = model_group
        self.spatial_group = spatial_group
        self._name = name
        self._kept_slice: tuple | None = None
        cout = 2 * features if conv_kind == "gated" else features
        self.weight = nn.Parameter(
            torch.empty(cout, in_features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Variance-scaling (fan-in, truncated normal) weights, zero bias:
        the JAX package's initializer, drawn from ``generator``."""
        fan_in = self.weight.shape[1] * self.kernel_size ** 2
        # std of a unit normal truncated to ±2
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            self.bias.zero_()

    def _epilogue(self, y: torch.Tensor) -> torch.Tensor:
        if self.conv_kind == "gated":
            return gated_epilogue(y, self.activation)
        return _activation(self.activation)(y)

    def _cut(self, t: torch.Tensor) -> torch.Tensor:
        """This member's rows of a weight or bias: its features (and, for
        a gated conv, the matching gates)."""
        group, f = self.model_group, self.features
        c = f // group.size
        lo = group.index * c
        if self.conv_kind == "gated":
            return torch.cat([t[lo:lo + c], t[f + lo:f + lo + c]])
        return t[lo:lo + c]

    def _member_params(self) -> tuple[torch.Tensor, torch.Tensor]:
        if torch.is_grad_enabled() and (self.weight.requires_grad
                                        or self.bias.requires_grad):
            return self._cut(self.weight), self._cut(self.bias)
        key = tuple((t.data_ptr(), t._version) for t in (self.weight,
                                                         self.bias))
        if self._kept_slice is None or self._kept_slice[0] != key:
            # normal tensors, also under inference_mode: the packed-weight
            # cache keys on their versions
            with torch.inference_mode(False), torch.no_grad():
                self._kept_slice = (key, self._cut(self.weight).clone(),
                                    self._cut(self.bias).clone())
        return self._kept_slice[1:]

    def _band(self, rows: int) -> tuple[int, int, int, int]:
        form = band_form(self.kernel_size, self.stride, self.dilation, rows,
                         self.pre_upsample)
        if form is None:
            raise ValueError(
                f"{self._name}: a {self.kernel_size}x{self.kernel_size} "
                f"stride-{self.stride} dilation-{self.dilation} conv has no "
                f"row-band form on a band of {rows} rows")
        return form

    def forward(self, x: torch.Tensor, valid: torch.Tensor | None = None):
        band, valid_in = None, valid
        if self.spatial_group is not None:
            band = self._band(x.shape[1])
            lo, hi, first, rows = band
            if self.conv_kind == "partial":
                if valid is None:
                    valid = torch.ones(x.shape[:3] + (1,),
                                       dtype=torch.float32, device=x.device)
                valid_in = halo(valid, self.spatial_group, lo, hi)
            else:
                valid_in = None
            x = halo(x, self.spatial_group, lo, hi)
        if self.model_group is None:
            weight, bias = self.weight, self.bias
        else:
            weight, bias = self._member_params()
            x = reduce_input_grad(x, self.model_group)
        y, valid_out = self._conv(x, valid_in, weight, bias)
        if band is not None:
            y = y[:, first:first + rows]
            valid_out = (valid_out[:, first:first + rows]
                         if self.conv_kind == "partial"
                         else _resize_valid(valid, self.stride))
        if self.model_group is not None:
            y = gather_channels(y, self.model_group)
        return y, valid_out

    def _conv(self, x: torch.Tensor, valid: torch.Tensor | None,
              weight: torch.Tensor, bias: torch.Tensor):
        x = x.to(self.compute_dtype)
        if self.s2d or self.pre_upsample:
            # cell / parity kernels from the float32 param, cast once inside
            bias = bias.to(self.compute_dtype)
            rewrite = (s2d_conv5x5_epilogue if self.s2d
                       else upsample2x_conv2d_epilogue)
            y = rewrite(x, weight, lambda m: self._epilogue(m + bias))
            return y, valid
        if self.conv_kind == "gated":
            # the float32 parameter itself: conv2d casts it, and the kernel
            # path keeps one packed copy per parameter version
            y = gated_conv(x, weight, bias, stride=self.stride,
                           dilation=self.dilation, activation=self.activation,
                           backend=self.backend)
            return y, _resize_valid(valid, self.stride)
        weight = weight.to(self.compute_dtype)
        if self.conv_kind == "partial":
            if valid is None:
                valid = torch.ones(x.shape[:3] + (1,), dtype=torch.float32,
                                   device=x.device)
            y, valid_out = partial_conv(x, valid, weight, bias,
                                        stride=self.stride,
                                        dilation=self.dilation,
                                        backend=self.backend)
            return _activation(self.activation)(y), valid_out
        y = self._epilogue(conv2d(x, weight, bias, stride=self.stride,
                                  dilation=self.dilation))
        return y, _resize_valid(valid, self.stride)


def band_form(kernel_size: int, stride: int, dilation: int, rows: int,
              pre_upsample: bool = False):
    """(halo above, halo below, first kept output row, kept rows) of a
    TF-SAME conv on a row band of ``rows`` rows (module docstring), or
    None where it has no band form."""
    if pre_upsample:
        return 1, 1, 2, 2 * rows
    eff = (kernel_size - 1) * dilation + 1
    if stride == 1:
        return (eff - 1) // 2, eff // 2, (eff - 1) // 2, rows
    if stride != 2 or rows % 2 or eff < 2:
        return None
    lo = (eff - 2) // 2
    for hi in (eff - 2 - lo, eff - 1 - lo):
        ext = rows + lo + hi
        top = (eff - 2 if ext % 2 == 0 else eff - 1) // 2   # the op's pad
        if top % 2 == 0:
            return lo, hi, top // 2, rows // 2
    return None


def _resize_valid(valid: torch.Tensor | None, stride: int):
    if valid is None or stride == 1:
        return valid
    return valid[:, ::stride, ::stride, :]


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x), min=eps)


class SNConv(nn.Module):
    """Discriminator conv, optionally spectrally normalized (Miyato et
    al.): one power-iteration step per call, in float32, on the kernel
    reshaped to (fan_in, Cout) in the JAX package's HWIO order, so the
    singular vector ``u`` (Cout,) carries over between the packages. ``u``
    is a buffer — training state that is checkpointed, not a parameter —
    and moves only when the call passes ``update_stats``. Gradients stop
    through ``u`` and ``v`` but not through σ = vᵀWu. With a
    ``spatial_group`` it takes one row band, as :class:`InpaintConv`
    does (:func:`band_form`); σ comes from the whole weight on every
    member.
    """

    def __init__(self, in_features: int, features: int, kernel_size: int = 5,
                 stride: int = 2, use_sn: bool = False,
                 activation: str = "leaky_relu",
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.use_sn = use_sn
        self.activation = activation
        self.compute_dtype = compute_dtype
        self.spatial_group: SpatialGroup | None = None
        self.weight = nn.Parameter(
            torch.empty(features, in_features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))
        if use_sn:
            self.register_buffer("u", torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator | None = None):
        InpaintConv.reset_parameters(self, generator)
        if self.use_sn:
            with torch.no_grad():
                self.u.copy_(torch.randn(self.u.shape, generator=generator))

    def forward(self, x: torch.Tensor, update_stats: bool = False):
        weight = self.weight
        if self.use_sn:
            # (Cout, Cin, kh, kw) → (kh·kw·Cin, Cout)
            w = weight.float().permute(2, 3, 1, 0).reshape(
                -1, weight.shape[0])
            with torch.no_grad():
                v = _l2_normalize(w @ self.u)
                u_new = _l2_normalize(w.t() @ v)
            sigma = torch.dot(v, w @ u_new)
            if update_stats:
                self.u = u_new
            weight = weight / sigma.to(weight.dtype)
        x = x.to(self.compute_dtype)
        group = self.spatial_group
        if group is not None:
            form = band_form(self.kernel_size, self.stride, 1, x.shape[1])
            if form is None:
                raise ValueError(
                    f"a {self.kernel_size}x{self.kernel_size} stride-"
                    f"{self.stride} discriminator conv has no row-band form "
                    f"on a band of {x.shape[1]} rows")
            lo, hi, first, rows = form
            x = halo(x, group, lo, hi)
        y = conv2d(x, weight.to(self.compute_dtype), self.bias,
                   stride=self.stride)
        if group is not None:
            y = y[:, first:first + rows]
        return _activation(self.activation)(y)
