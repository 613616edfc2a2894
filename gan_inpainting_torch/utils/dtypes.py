"""Mixed-precision dtype policy: params are always float32; convs and
matmuls compute in bfloat16 (``model.dtype_policy=bf16``) or in float32
throughout (``f32``: the parity tests and the card's full-precision
check)."""

from __future__ import annotations

import dataclasses

import torch

_COMPUTE = {"bf16": torch.bfloat16, "f32": torch.float32}


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    compute_dtype: torch.dtype = torch.bfloat16

    @classmethod
    def from_name(cls, name: str) -> "DTypePolicy":
        if name not in _COMPUTE:
            raise ValueError(f"unknown dtype_policy {name!r} (bf16 | f32)")
        return cls(compute_dtype=_COMPUTE[name])
