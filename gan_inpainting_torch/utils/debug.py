"""Debug tooling: ``trace(workdir, device)``, a ``torch.profiler`` trace
around a block (host activity, and the card's kernels when on CUDA),
written as a Chrome trace under ``workdir/profile``.

The JAX package's ``debug_mode`` (NaN checks) and ``interpret_kernels``
(every kernel's plain version) are not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import contextlib
import pathlib

import torch

from gan_inpainting_torch.ops.dispatch import resolve_device


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
