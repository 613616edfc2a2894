"""Kernel dispatch by tensor device, device resolution and launch counts.

Every op that owns a hand-written CUDA kernel has one wrapper that picks by
the device of the tensor it is given: a CUDA tensor launches the kernel (or
the wrapper raises), a CPU tensor takes the op's plain PyTorch version.
There is no switch and no fallback from a kernel that failed to build or
launch.

``launches`` counts kernel launches per kernel name. Each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import torch

launches: dict[str, int] = {}


def count_launch(name: str) -> None:
    launches[name] = launches.get(name, 0) + 1


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def use_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no implementation for device {x.device}")


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. With no device asked for and no card present, raise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
