"""The serving kernels as ``torch.library`` operators (namespace
``gan_inpainting``), so that ``torch.export`` sees them.

A kernel wrapper that launches through ctypes on raw pointers cannot be
traced: tracing runs on FakeTensors, which have no storage, and a launch
count kept beside the call would count once at export and never when the
exported program runs. So each of the six kernels on a serving path is an
operator with three implementations, registered by its wrapper module
through :func:`implement`:

* ``CUDA``: the launch itself — validation, host prep, planning,
  allocation, the library build, the stream and the launch count — or,
  inside ``interpret_kernels``, the kernel's mirror;
* ``CPU``: the op's plain PyTorch version (or the mirror);
* fake: output shapes and dtypes only, which the exporter traces with.

The eager path calls the same operators; route and plan choices that
depend only on shapes (``fused_route``, ``direct_conv_supported``,
``resolve_backend``) stay in Python in front of them, so an export fixes
them as ``jax.export`` fixes its trace. The operators have no autograd
formula: a forward that a gradient follows calls them inside the
autograd Functions of the wrappers (``_GatedConv``, ``_PartialEpilogue``,
``_FusedAttention``, ``PatchAttention``), whose backwards are the kernels'
own. The backward kernels are not operators and cannot be exported; no
serving path reaches them.

An exported program names each operator, not its code: :data:`SOURCES`
(filled as each wrapper registers its op) says which ``csrc/`` library
each launches, and io/aot.py pins those libraries' build hashes in the
artifact's manifest.
"""

from __future__ import annotations

import importlib

import torch

NAMESPACE = "gan_inpainting"

# op → (the wrapper module that registers its implementations, its
# schema). An output that a flag can leave out (the log-sum-exp) is an empty
# tensor then.
OPS = {
    "fused_attention_taps": ("fused_attention", (
        "(Tensor b_feat, Tensor hole_mask, int ksize, int rate, "
        "float softmax_scale, bool want_lse) -> (Tensor, Tensor)")),
    "fold_taps": ("fold", "(Tensor taps, int hs, int ws, int rate) -> Tensor"),
    "gated_conv_direct": ("direct_conv", (
        "(Tensor x, Tensor weight, Tensor packed, Tensor bias, int dilation, "
        "str activation) -> Tensor")),
    "gated_conv_matmul": ("gated_matmul", (
        "(Tensor x, Tensor weight, Tensor packed, Tensor bias, int stride, "
        "int dilation, str activation) -> Tensor")),
    "partial_epilogue": ("partial_epilogue", (
        "(Tensor raw, Tensor counts, Tensor bias, int window) "
        "-> (Tensor, Tensor)")),
    "patch_attention": ("patch_attention", (
        "(Tensor q, Tensor k, Tensor key_valid, Tensor v, "
        "float softmax_scale, bool want_lse) -> (Tensor, Tensor)")),
}

# op → the csrc/ library its CUDA implementation launches (build.SOURCES),
# filled by implement()
SOURCES: dict[str, str] = {}

_lib = torch.library.Library(NAMESPACE, "DEF")
for _name, (_, _schema) in OPS.items():
    _lib.define(_name + _schema)


def implement(name: str, *, source: str, cpu, cuda, fake):
    """Register the CPU, CUDA and fake implementations of op ``name``,
    whose CUDA implementation launches the kernels of library ``source``;
    returns its overload, which the wrapper calls."""
    _lib.impl(name, cpu, "CPU")
    _lib.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_lib)
    SOURCES[name] = source
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def load_all() -> None:
    """Import every wrapper module, so that every op has its
    implementations (a loaded exported program calls them by name)."""
    for module in sorted({module for module, _ in OPS.values()}):
        importlib.import_module(f"gan_inpainting_torch.ops.kernels.{module}")


def ops_in(graph) -> list[str]:
    """The names of this namespace's ops that ``graph`` (an FX graph)
    calls, each once, in order of first call."""
    found: list[str] = []
    for node in graph.nodes:
        t = node.target
        if (isinstance(t, torch._ops.OpOverload) and t.namespace == NAMESPACE
                and t._opname not in found):
            found.append(t._opname)
    return found


def empty_lse(x: torch.Tensor) -> torch.Tensor:
    """The (0,) float32 stand-in for a log-sum-exp that was not asked for."""
    return x.new_empty((0,), dtype=torch.float32)
