"""Debug / sanitizer switches, the counterparts of the JAX package's:

* ``debug_mode()``: NaN checks and autograd's anomaly detection for the
  block (``jax_debug_nans`` / ``jax_enable_checks`` there).
* ``interpret_kernels()``: every kernel wrapper takes its kernel's mirror,
  the kernel's tiling and order of sums in PyTorch, instead of launching
  it (Pallas interpret mode there; ops/dispatch.py).
* ``trace(workdir, device)``: a ``torch.profiler`` trace around a block
  (host activity, and the card's kernels when on CUDA), written as a
  Chrome trace under ``workdir/profile``.
"""

from __future__ import annotations

import contextlib
import pathlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from gan_inpainting_torch.ops.dispatch import interpret_kernels, resolve_device

__all__ = ["debug_mode", "interpret_kernels", "trace"]

_aten = torch.ops.aten
# outputs that hold whatever the allocator gave, written later
_UNINITIALIZED = {_aten.empty, _aten.empty_like, _aten.empty_strided,
                  _aten.new_empty, _aten.new_empty_strided}


def _aliases_input(func) -> bool:
    """A view: every result aliases an input without writing it, so its
    values were checked where they were made."""
    returns = func._schema.returns
    return bool(returns) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in returns)


class _NanCheck(TorchDispatchMode):
    """Raise ``FloatingPointError`` at the first op whose floating output
    holds a NaN. Each check reads a flag back from the device, so every op
    waits for the card."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in _UNINITIALIZED or _aliases_input(func):
            return out
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and t.numel() and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def debug_mode(nans: bool = True, checks: bool = True):
    """``nans``: raise ``FloatingPointError`` naming the op at the first
    op of this thread whose floating output holds a NaN. ``checks``:
    ``torch.autograd.set_detect_anomaly(True, check_nan=True)``, so a
    backward function that returns a NaN raises, with the traceback of
    the forward op that made it. Both are restored on exit.

    A hand-written kernel is launched through ctypes, which PyTorch does
    not dispatch: a NaN that a kernel writes is caught at the first op
    that reads it and carries it into its output."""
    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    with contextlib.ExitStack() as stack:
        if checks:
            torch.autograd.set_detect_anomaly(True, check_nan=True)
            stack.callback(torch.autograd.set_detect_anomaly, *prev)
        if nans:
            stack.enter_context(_NanCheck())
        yield


@contextlib.contextmanager
def trace(workdir: str, device: str | torch.device | None = None):
    """Profile the block; yields the ``torch.profiler.profile`` and writes
    ``workdir/profile/trace.json`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(workdir) / "profile"
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = out / "trace.json"
    prof.export_chrome_trace(str(path))
    print(f"[profile] wrote trace to {path} (view: ui.perfetto.dev or "
          "chrome://tracing)")
