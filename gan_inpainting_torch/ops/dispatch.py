"""Kernel dispatch: backend names, tensor device, launch counts.

Every op that owns a hand-written CUDA kernel has one wrapper that picks by
the device of the tensor it is given: a CUDA tensor launches the kernel (or
the wrapper raises), a CPU tensor takes the op's plain PyTorch version.
There is no fallback from a kernel that failed to build or launch.

Above the wrappers sits the config's ``model.kernel_backend`` switch, with
the JAX package's three values kept letter for letter so that exported
configs load and mean the same thing (:func:`resolve_backend`):

* ``pallas`` — the op's hand-written CUDA kernel (on a CPU tensor the
  wrapper's plain version);
* ``xla``    — the library composition: cuDNN conv plus eager elementwise
  passes, the dense plain attention;
* ``auto``   — per op, what :data:`AUTO_CUDA` says.

``launches`` counts kernel launches per kernel name. Each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels.

``interpret_kernels()`` is the counterpart of Pallas interpret mode: inside
the block no kernel launches, and every wrapper that would launch one takes
that kernel's mirror instead (its tiling and order of sums, in PyTorch),
on any device. Wrappers read the one global flag through
:func:`interpreting`; a kernel without a mirror (the partial-conv epilogue)
takes its plain version. Routes (fused or patch attention, the backends)
are chosen as outside the block.

``section(name)`` marks a named stretch of work (the train step's phases,
the attention backward). It does nothing unless a measuring tool installs
a hook with ``set_section_hook``: a function ``name -> context manager``
that, say, records CUDA events around the stretch.
"""

from __future__ import annotations

import contextlib
import threading

import torch

VALID = ("auto", "xla", "pallas")

# What "auto" means per op on a CUDA card, set by measurement on one NVIDIA
# H100 80GB HBM3, 700.00 W: chip_smoke.py phases [4], [5] and [6], the
# backends timed in turns within one run. PERF.md §6 quotes the same runs
# beside the kernels' own times.
# * contextual_attention: the fused kernel (the plain path materializes the
#   (Lq, Lk) score matrix; serve_v4_8 693.9 img/s with it, 637.5 without).
# * gated_conv: the library composition, by the rule that the kernels
#   must gain on serving by more than the spread of the turns and must not
#   slow the train step by more than its spread. Serving gains: the
#   serve_v4_8 64x256² forward takes 67.33 / 67.39 ms with every gated
#   conv in the wgmma kernels (950 img/s) against 92.37 / 92.35 ms with
#   cuDNN convs and eager epilogues (693 img/s). Training loses: the
#   places512_deepfill 8x512² step takes 317.16 / 316.78 ms against
#   305.58 / 305.18 ms, since the kernels' backward recomputes the forward
#   through the library (as the JAX kernels' custom VJP), so a step with
#   gradients pays for the kernel on top.
# * partial_conv: the epilogue kernel. partialconv256 serves at 2964.6 img/s
#   with it and at 2069.0 img/s with the eager epilogue (0.30 ms against
#   1.64 ms per call at C = 48, 64x256²). The choice rests on the serve
#   rates: the 16x256² train step is partly host-bound and its two times
#   (63.1 and 58.2 ms, in turns) lie within the host's spread.
AUTO_CUDA = {
    "contextual_attention": "pallas",
    "gated_conv": "xla",
    "partial_conv": "pallas",
}

_local = threading.local()


def resolve_backend(backend: str = "auto", op: str | None = None) -> str:
    """``pallas`` or ``xla`` for one op, from a config value (or the value
    forced by :func:`override_backend`)."""
    forced = getattr(_local, "forced", None)
    if forced is not None:
        backend = forced
    if backend not in VALID:
        raise ValueError(f"backend must be one of {VALID}, got {backend!r}")
    if backend == "auto":
        return AUTO_CUDA.get(op, "pallas") if op else "pallas"
    return backend


@contextlib.contextmanager
def override_backend(backend: str):
    """Force a backend for all ops inside the context (tests, benchmarks)."""
    prev = getattr(_local, "forced", None)
    _local.forced = backend
    try:
        yield
    finally:
        _local.forced = prev


launches: dict[str, int] = {}
_interpret = False            # set by interpret_kernels, for every thread


@contextlib.contextmanager
def interpret_kernels():
    """Run every kernel's mirror instead of the kernel inside the block, in
    every thread, as ``pltpu.force_tpu_interpret_mode`` does for Pallas;
    the previous setting is restored on exit."""
    global _interpret
    prev = _interpret
    _interpret = True
    try:
        yield
    finally:
        _interpret = prev


def interpreting() -> bool:
    """True inside :func:`interpret_kernels`: take the mirror."""
    return _interpret


def count_launch(name: str) -> None:
    launches[name] = launches.get(name, 0) + 1


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def use_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version) and inside :func:`interpret_kernels`, where
    nothing launches; any other device raises."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no implementation for device {x.device}")
    return x.device.type == "cuda" and not _interpret


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. With no device asked for and no card present, raise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


_section_hook = None


def set_section_hook(hook) -> None:
    """Install (or with None remove) the hook behind :func:`section`."""
    global _section_hook
    _section_hook = hook


def section(name: str):
    return (contextlib.nullcontext() if _section_hook is None
            else _section_hook(name))
