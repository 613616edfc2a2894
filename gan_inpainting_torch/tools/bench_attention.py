"""Time the bf16 attention kernels at the table shapes, on one CUDA card.

    python -m gan_inpainting_torch.tools.bench_attention [--turns 2]
        [--cases fused,patch,patch_bwd,fused_bwd,folds]

Shapes: the fused forward at the 256² serve map (B 8, 64×64×192) and the
512² map (B 2, 128×128×192); the patch forward at B 2, L 16 384, d 1728,
dv 3072 (70 % of keys valid). For each, per turn: ms of the kernel launch
alone (prepared maps, or materialized Q/K/V with lse), ms of one
``scaled_dot_product_attention`` call over the same patches (a yardstick,
never called by the port), and the kernel's largest error against the
plain version (bf16 inputs, the plain version in float32 on the same
values; lse absolute). ``patch_bwd``: the patch dQ and dK/dV kernels at
B 2, L 16 384 (with their largest errors against the plain formulas as a
fraction of the largest reference entry, and the autograd backward of the
same SDPA call, dq, dk and dv in one) and at B 1, L 65 536 (the 2048²
map; times only), with TFLOP/s over the (query, valid key) pairs; with
``--phases``, also the wgmma kernels' cycles per step in each phase of
their mainloop (``patch_attention.BWD_PHASES``, averaged over blocks).
``fused_bwd``: the rule of ``FUSED_MAX_CELLS`` — at B 2, C 192, bf16,
maps of 1024, 2048, 4096, 8192 and 16 384 cells, contextual attention's
forward + backward through the fused route and through the patch route in
turns (fused, patch, patch, fused per turn), then the fused backward's
kernels alone (``fused_attention_bwd.tap_grads``, all chunks) with
TFLOP/s over all (query, key) pairs. ``folds``: the forward's fold
(``fold.fold_taps``) on bf16 taps at B 8 and B 64 on the 256² map and
at the 8×512² train map, the wrapper by CUDA events and its kernel's
device time by ``torch.profiler``; and the fused backward's epilogue
(``fused_attention_bwd.fold_tap_grads``, cast to the feature dtype) on
float32 tap gradients at the 16×256² and 8×512² train maps. One JSON
line per shape, and the card's name and power limit.

It uses only entry points that every version of the port has
(``fused_attention._prepare``/``_launch``, ``patch_attention.launch_fwd``,
``launch_dq``, ``launch_dkv``, ``plan``, ``fold.fold_taps``,
``fused_attention_bwd.prepare_bwd``/``fold_tap_grads``), so two versions can be timed in
turns on one card: run this file as a script with ``PYTHONPATH`` at the
other checkout, e.g. ``PYTHONPATH=../parent python
gan_inpainting_torch/tools/bench_attention.py --cases patch_bwd``.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int, needle: str) -> float:
    """Mean device ms per call of the CUDA kernels whose name holds
    ``needle`` (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA and needle in e.name
               ) / 1e3 / reps


def fold_case(bsz: int, hw: int, turns: int) -> dict:
    """The forward's fold on (B, 16, (hw/2)², 192) bf16 taps."""
    from gan_inpainting_torch.ops.kernels.fold import fold_taps

    gen = torch.Generator(device="cuda").manual_seed(hw + bsz)
    hs = hw // 2
    taps = torch.randn((bsz, 16, hs * hs, 192), generator=gen,
                       device="cuda").to(torch.bfloat16)
    turns_ms = [(_time_ms(lambda: fold_taps(taps, hs, hs, 2), 20),
                 _device_ms(lambda: fold_taps(taps, hs, hs, 2), 20,
                            "fold_kernel")) for _ in range(turns)]
    return dict(shape=f"fold B{bsz} {hw}x{hw}x192 bf16",
                wrapper_ms=[t[0] for t in turns_ms],
                kernel_ms=[t[1] for t in turns_ms])


def tap_grad_fold_case(bsz: int, hw: int, turns: int) -> dict:
    """The fused backward's epilogue on float32 tap gradients of a bf16
    (B, hw, hw, 192) map, through the gradient in the map's dtype."""
    from gan_inpainting_torch.ops.kernels import fused_attention_bwd as fab

    gen = torch.Generator(device="cuda").manual_seed(hw * bsz)
    x = torch.relu(torch.randn((bsz, hw, hw, 192), generator=gen,
                               device="cuda")).to(torch.bfloat16)
    hole = torch.zeros((bsz, hw, hw, 1), device="cuda")
    g = torch.randn(x.shape, generator=gen, device="cuda")
    maps, _, _, rnorm, (hs, ws) = fab.prepare_bwd(x, hole, g, 3, 2)
    lk = hs * ws

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    dq, dk, dv = randn(bsz, 9, lk, 192), randn(bsz, 9, lk, 192), randn(
        bsz, 16, lk, 192)
    tnorm = randn(bsz, lk)
    turns_ms = [_time_ms(lambda: fab.fold_tap_grads(
        maps, dq, dk, dv, tnorm, rnorm, hs, ws, 2, 10.0).to(maps.dtype), 10)
        for _ in range(turns)]
    return dict(shape=f"tap-gradient fold B{bsz} {hw}x{hw}x192 bf16",
                ms=turns_ms)


def fused_case(bsz: int, hw: int, turns: int) -> dict:
    from gan_inpainting_torch.ops.contextual_attention import (
        _attention_inputs,
    )
    from gan_inpainting_torch.ops.kernels import fused_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(hw)
    x = torch.relu(torch.randn((bsz, hw, hw, 192), generator=gen,
                               device="cuda")).to(torch.bfloat16)
    hole = (torch.rand((bsz, hw, hw, 1), generator=gen, device="cuda")
            < 0.02).float()
    hs = hw // 2
    maps, bias, rnorm, _ = fa._prepare(x, hole, 3, 2)
    got, lse = fa._launch(maps, bias, rnorm, hs, hs, 2, 10.0, want_lse=True)
    want, want_lse = fa.fused_attention_taps_plain(x.float(), hole,
                                                   want_lse=True)
    q, k, valid, v, _ = _attention_inputs(x, x, hole, 3, 2)
    mask = valid[:, None, None, :]
    turns_ms = [(
        _time_ms(lambda: fa._launch(maps, bias, rnorm, hs, hs, 2, 10.0), 10),
        _time_ms(lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], v[:, None], attn_mask=mask, scale=10.0),
            5)) for _ in range(turns)]
    return dict(shape=f"fused B{bsz} {hw}x{hw}x192", plan=fa.plan(
        hs, hs, 192, torch.bfloat16), kernel_ms=[t[0] for t in turns_ms],
        sdpa_ms=[t[1] for t in turns_ms],
        max_abs_err=(got.float() - want).abs().max().item(),
        tol=2.0 ** -7 * x.float().abs().max().item(),
        lse_err=(lse - want_lse).abs().max().item())


def patch_case(bsz: int, length: int, turns: int) -> dict:
    from gan_inpainting_torch.ops.kernels import patch_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(length)
    d, dv = 1728, 3072
    q = torch.randn((bsz, length, d), generator=gen, device="cuda")
    k = F.normalize(torch.randn((bsz, length, d), generator=gen,
                                device="cuda"), dim=-1)
    v = torch.randn((bsz, length, dv), generator=gen, device="cuda")
    q, k, v = (t.to(torch.bfloat16).contiguous() for t in (q, k, v))
    valid = torch.rand((bsz, length), generator=gen, device="cuda") < 0.7
    out, lse = pa.launch_fwd(q, k, valid, v, 10.0, want_lse=True)
    err = lse_err = ref = 0.0
    for c0 in range(0, length, 4096):
        o, l_ = pa.patch_attention_plain(q[:, c0:c0 + 4096].float(),
                                         k.float(), valid, v.float(),
                                         softmax_scale=10.0, want_lse=True)
        err = max(err, (out[:, c0:c0 + 4096].float() - o).abs().max().item())
        lse_err = max(lse_err, (lse[:, c0:c0 + 4096] - l_).abs().max().item())
        ref = max(ref, o.abs().max().item())
    mask = torch.where(valid, 0.0, -1e9).to(q.dtype)[:, None, None, :]
    turns_ms = [(
        _time_ms(lambda: pa.launch_fwd(q, k, valid, v, 10.0, want_lse=True),
                 3),
        _time_ms(lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], v[:, None], attn_mask=mask, scale=10.0),
            2)) for _ in range(turns)]
    return dict(shape=f"patch B{bsz} L{length} d{d} dv{dv}",
                plan=pa.plan(d, dv, torch.bfloat16),
                kernel_ms=[t[0] for t in turns_ms],
                sdpa_ms=[t[1] for t in turns_ms], max_abs_err=err,
                tol=2.0 ** -7 * max(ref, 1.0), lse_err=lse_err)


def _patch_inputs(bsz: int, length: int, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, dv = 1728, 3072
    q = torch.randn((bsz, length, d), generator=gen, device="cuda")
    k = F.normalize(torch.randn((bsz, length, d), generator=gen,
                                device="cuda"), dim=-1)
    v = torch.randn((bsz, length, dv), generator=gen, device="cuda")
    g = torch.randn((bsz, length, dv), generator=gen, device="cuda")
    valid = torch.rand((bsz, length), generator=gen, device="cuda") < 0.7
    return (*(t.to(torch.bfloat16).contiguous() for t in (q, k, v, g)),
            valid)


def patch_bwd_case(bsz: int, length: int, turns: int,
                   phases: bool = False) -> dict:
    """dQ and dK/dV from the kernel forward's own out and lse; errors and
    the SDPA yardstick where the dense plain version fits (L ≤ 16 384)."""
    from gan_inpainting_torch.ops.kernels import patch_attention as pa

    q, k, v, g, valid = _patch_inputs(bsz, length, length + 1)
    d, dv = q.shape[-1], v.shape[-1]
    out, lse = pa.launch_fwd(q, k, valid, v, 10.0, want_lse=True)
    delta = (g.float() * out.float()).sum(-1)
    pairs = 2.0 * length * int(valid.sum().item())
    flops = {"dq": pairs * (2 * d + dv), "dkv": pairs * (2 * d + 2 * dv)}
    res = dict(shape=f"patch bwd B{bsz} L{length} d{d} dv{dv}",
               plan={w: pa.plan(d, dv, torch.bfloat16, w)
                     for w in ("dq", "dkv")})
    small = length <= 16384
    if small:
        dq = pa.launch_dq(q, k, valid, v, g, lse, delta, 10.0)
        dk, dv_ = pa.launch_dkv(q, k, valid, v, g, lse, delta, 10.0)
        want = pa.patch_attention_bwd_plain(
            q.float(), k.float(), valid, v.float(), out.float(), lse,
            g.float(), softmax_scale=10.0, keep_float=True)
        res["rel_err"] = {
            n: (a.float() - w).abs().max().item() / max(
                w.abs().max().item(), 1.0)
            for n, a, w in zip(("dq", "dk", "dv"), (dq, dk, dv_), want)}
        del dq, dk, dv_, want
        mask = torch.where(valid, 0.0, -1e9).to(q.dtype)[:, None, None, :]
        leaves = [t[:, None].detach().requires_grad_(True) for t in (q, k, v)]
        y = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                           scale=10.0)
        gy = g[:, None]
    reps = 3 if small else 1
    turns_ms = []
    for _ in range(turns):
        t = {"dq": _time_ms(lambda: pa.launch_dq(
                q, k, valid, v, g, lse, delta, 10.0), reps),
             "dkv": _time_ms(lambda: pa.launch_dkv(
                 q, k, valid, v, g, lse, delta, 10.0), reps)}
        if small:
            t["sdpa_bwd"] = _time_ms(lambda: torch.autograd.grad(
                y, leaves, gy, retain_graph=True), 2)
        turns_ms.append(t)
    res.update({f"{n}_ms": [t[n] for t in turns_ms] for n in turns_ms[0]})
    if phases:
        res["phase_cycles_per_step"] = {}
        for name in ("dq", "dkv"):
            clocks = torch.zeros(8, dtype=torch.int64, device="cuda")
            pa._launch_bwd(name, q, k, valid, v, g, lse, delta, 10.0, None,
                           clocks=clocks)
            c = clocks.tolist()
            res["phase_cycles_per_step"][name] = {
                ph: c[i] / c[7] for i, ph in enumerate(pa.BWD_PHASES)}
    res["tflops"] = {n: [flops[n] / t[n] / 1e9 for t in turns_ms]
                     for n in ("dq", "dkv")}
    return res


def fused_bwd_case(h: int, w: int, turns: int) -> dict:
    """Forward + backward of contextual attention on a B 2, h × w × 192
    bf16 feature map (rate 2: (h/2)·(w/2) cells) through each route, in
    turns; a block of the map is hole."""
    from gan_inpainting_torch.ops.contextual_attention import (
        _FusedAttention,
        _patch_route,
    )
    from gan_inpainting_torch.ops.kernels import fused_attention_bwd as fab
    from gan_inpainting_torch.ops.kernels.fused_attention import (
        fused_attention_taps,
    )

    gen = torch.Generator(device="cuda").manual_seed(h * w)
    x = torch.relu(torch.randn((2, h, w, 192), generator=gen,
                               device="cuda")).to(torch.bfloat16)
    hole = torch.zeros((2, h, w, 1), device="cuda")
    hole[:, h // 4:h // 2, w // 4:w // 2] = 1.0
    g = torch.randn(x.shape, generator=gen, device="cuda").to(torch.bfloat16)
    hs, ws = h // 2, w // 2

    def train(route):
        leaf = x.detach().requires_grad_(True)
        y = (_FusedAttention.apply(leaf, hole, 3, 2, 10.0)
             if route == "fused"
             else _patch_route(leaf, leaf, hole, 3, 2, 10.0))
        y.backward(g)
        return leaf.grad

    diff = (train("fused").float() - train("patch").float()).abs().max()
    times = {"fused": [], "patch": []}
    for _ in range(turns):
        for route in ("fused", "patch", "patch", "fused"):
            times[route].append(_time_ms(lambda: train(route), 1))
    taps, lse = fused_attention_taps(x, hole, want_lse=True)
    maps, gmaps, bias, rnorm, _ = fab.prepare_bwd(x, hole, g, 3, 2)
    kernels_ms = _time_ms(lambda: fab.tap_grads(
        maps, gmaps, bias, rnorm, lse, taps, hs, ws, 2, 10.0), 2)
    lk = hs * ws
    flops = 2.0 * 2 * lk * lk * 192 * 59
    return dict(shape=f"routes B2 {h}x{w}x192 (L {lk}) bf16",
                plan=fab.plan_bwd(hs, ws, 192, torch.bfloat16)._asdict(),
                fused_train_ms=times["fused"], patch_train_ms=times["patch"],
                grad_max_abs_diff=diff.item(),
                fused_bwd_kernels_ms=kernels_ms,
                fused_bwd_tflops_all_pairs=flops / kernels_ms / 1e9)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--cases", default="fused,patch,patch_bwd",
                    help="comma-separated subset of fused, patch, "
                    "patch_bwd, fused_bwd, folds")
    ap.add_argument("--phases", action="store_true",
                    help="patch_bwd: cycles per step in each mainloop phase")
    args = ap.parse_args()
    cases = args.cases.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    runs = []
    if "fused" in cases:
        runs += [lambda: fused_case(8, 64, args.turns),
                 lambda: fused_case(2, 128, args.turns)]
    if "patch" in cases:
        runs.append(lambda: patch_case(2, 16384, args.turns))
    if "patch_bwd" in cases:
        runs += [lambda: patch_bwd_case(2, 16384, args.turns, args.phases),
                 lambda: patch_bwd_case(1, 65536, args.turns, args.phases)]
    if "fused_bwd" in cases:
        runs += [lambda h=h, w=w: fused_bwd_case(h, w, args.turns)
                 for h, w in ((64, 64), (64, 128), (128, 128), (128, 256),
                              (256, 256))]
    if "folds" in cases:
        runs += [lambda b=b, hw=hw: fold_case(b, hw, args.turns)
                 for b, hw in ((8, 64), (64, 64), (8, 128))]
        runs += [lambda b=b, hw=hw: tap_grad_fold_case(b, hw, args.turns)
                 for b, hw in ((16, 64), (8, 128))]
    for run in runs:
        print(json.dumps(run(), default=str), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
