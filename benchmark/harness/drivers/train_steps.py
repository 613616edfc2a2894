"""Training steps: the per-step path of the program's ``train()`` loop.
Each step takes a batch of seeded uint8 images from a pool on the device
through ``make_train_batch`` (flips and free-form masks drawn on the CPU
from a generator of the step, rasterized on the device) into the step
``make_train_step`` builds, with no wait for the device between steps.

Set-up is ``setup_rank`` with the benchmark's weights loaded into G, D
and the EMA. It then drives that same state through its first three
steps (step 0 takes lazy R1), on pool batches that all differ, and keeps
what the check compares: each step's D and G loss, the first gradient
of every leaf as Adam holds it after step 0 (its first moment over
1 − β1), and each leaf's change after the three steps. The warm-up runs
on to the next step ≡ 0 (mod ``r1_interval``), where the window starts.

The check runs the reference's three steps on the same weights, images
and mask draws, in float32, after the program has been freed.

Parameters: ``pool_batches``, ``checked_steps``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import count, inputs, spec
from benchmark.harness.serving import free
from benchmark.reference import deepfill
from benchmark.reference import train as ref_train


def hyper(cfg) -> ref_train.Hyper:
    """The reference's hyperparameters, read from the configuration."""
    m, lc, tc = cfg.model, cfg.loss, cfg.train
    return ref_train.Hyper(
        base_features=m.base_features, disc_features=m.disc_features,
        disc_layers=m.disc_layers, g_lr=tc.g_lr, d_lr=tc.d_lr,
        beta1=tc.beta1, beta2=tc.beta2, r1_gamma=lc.r1_gamma,
        r1_interval=lc.r1_interval, l1_weight=lc.l1_weight,
        l1_hole_weight=lc.l1_hole_weight, l1_valid_weight=lc.l1_valid_weight,
        gan_weight=lc.gan_weight, ema_decay=tc.g_ema_decay)


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().float()))
            for k, v in tensors.items()}


def leaf_gaps(got: dict, want: dict, keep=None) -> dict:
    """Each leaf's gap between two norms, over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    keys = [k for k in want if keep is None or k in keep]
    med = float(np.median([want[k] for k in keys]))
    return {k: abs(got.get(k, 0.0) - want[k]) / max(want[k], med, 1e-30)
            for k in keys}


def moving_leaves(first_grads: dict) -> set:
    """Leaves whose first gradient in the reference is at least a
    thousandth of the median leaf's: the others move by round-off alone
    under Adam and are left out of the change."""
    med = float(np.median(list(first_grads.values())))
    return {k for k, v in first_grads.items() if v >= 1e-3 * med}


def _keep(ref: dict) -> set:
    """The leaves whose change is compared: those that move (and their
    EMA)."""
    moving = moving_leaves(ref["first"])
    return moving | {f"ema.{k[2:]}" for k in moving if k.startswith("g.")}


class Driver:
    def __init__(self, run):
        self.run = run
        self.n_pool = int(run.params["pool_batches"])
        self.n_checked = int(run.params["checked_steps"])

    def _batch(self, step: int):
        from gan_inpainting_torch.data.pipeline import make_train_batch

        cfg = self.cfg
        return make_train_batch(
            self.pool[step % self.n_pool],
            inputs.cpu_generator(self.run.seed, "train_masks", step),
            cfg.mask, 1.0, flip=cfg.data.random_flip)

    def setup(self) -> None:
        from gan_inpainting_torch.train.loop import setup_rank
        from gan_inpainting_torch.train.step import make_train_step

        run = self.run
        cfg = self.cfg = spec.program_config(run.cell, run.extra_overrides)
        m = cfg.model
        self.h = hyper(cfg)
        self.g0 = inputs.generator_params(m.base_features, run.seed,
                                          run.device)
        self.d0 = inputs.discriminator_params(m.disc_features, m.disc_layers,
                                              run.seed, run.device)
        rank = setup_rank(cfg, run.device)
        state = self.state = rank.state
        state.generator.load_state_dict(self.g0)
        state.discriminator.load_state_dict(self.d0)
        for k, v in state.g_ema.items():
            v.copy_(self.g0[k])
        b, s = cfg.data.batch_size, cfg.data.image_size
        self.pool = inputs.images_u8(self.n_pool * b, s, run.seed,
                                     run.device, "train").view(
            self.n_pool, b, s, s, 3)
        self.step_fn = make_train_step(cfg)

        g_names = {id(p): k for k, p in state.generator.named_parameters()}
        d_names = {id(p): k for k, p in state.discriminator.named_parameters()}
        self.losses, beta1 = [], cfg.train.beta1
        for step in range(self.n_checked):
            metrics = self.step_fn(state, self._batch(step))
            self.losses.append({k: float(metrics[k])
                                for k in ("d_loss", "g_loss")})
            if step == 0:
                self.first, self.first_vecs = {}, {}
                for opt, names, tag in ((state.g_opt, g_names, "g"),
                                        (state.d_opt, d_names, "d")):
                    for p, st in opt.state.items():
                        k = f"{tag}.{names[id(p)]}"
                        self.first[k] = float(
                            torch.linalg.vector_norm(st["exp_avg"])
                            / (1.0 - beta1))
                        if run.params.get("keep_vectors"):
                            self.first_vecs[k] = (st["exp_avg"].float().cpu()
                                                  / (1.0 - beta1))
        self.changes = {
            **{f"g.{k}": v for k, v in norms(
                {k: p - self.g0[k] for k, p in
                 state.generator.named_parameters()}).items()},
            **{f"d.{k}": v for k, v in norms(
                {k: p - self.d0[k] for k, p in
                 state.discriminator.named_parameters()}).items()},
            **{f"ema.{k}": v for k, v in norms(
                {k: p - self.g0[k] for k, p in state.g_ema.items()}).items()},
        }
        every = max(cfg.loss.r1_interval, 1)
        while state.step % every:
            self.step_fn(state, self._batch(state.step))
        if run.device.type == "cuda":
            torch.cuda.synchronize()

    def measure(self) -> dict:
        run, tracer, state = self.run, self.run.tracer, self.state
        first, steps = state.step, 0
        with tracer.window():
            t0 = time.perf_counter()
            while True:
                with tracer.span("batch_build"):
                    batch = self._batch(state.step)
                with tracer.span("step_dispatch"):
                    self.step_fn(state, batch)
                steps += 1
                if time.perf_counter() - t0 >= run.seconds:
                    break
            with tracer.span("sync"):
                if run.device.type == "cuda":
                    torch.cuda.synchronize()
            t1 = time.perf_counter()
        b = self.cfg.data.batch_size
        every = max(self.cfg.loss.r1_interval, 1)
        r1 = sum(1 for s in range(first, first + steps) if s % every == 0)
        run.log(f"window: steps {first}..{first + steps - 1}, {r1} with R1")
        return {"seconds": t1 - t0, "steps": steps, "first_step": first,
                "images": steps * b, "attempted": steps * b, "failed": 0,
                "r1_steps": r1}

    def release(self) -> None:
        self.checked_images = [self.pool[s % self.n_pool].clone()
                               for s in range(self.n_checked)]
        self.state = self.step_fn = self.pool = None
        free()

    def reference(self, q=None, half=False) -> dict:
        """The reference's readings over the checked steps: losses, first
        gradients, changes. ``q`` rounds its operands (the control);
        ``half`` leaves out the second half of each batch (a fault)."""
        run, h = self.run, self.h
        t0 = time.perf_counter()
        s = ref_train.State(self.g0, self.d0, h)
        m = inputs.mask_params(self.cfg)
        losses, first = [], None
        with deepfill.float32_exact():
            for step in range(self.n_checked):
                image, mask = ref_train.train_batch(
                    self.checked_images[step],
                    inputs.cpu_generator(run.seed, "train_masks", step), m,
                    self.cfg.data.random_flip, run.device)
                if half:
                    image, mask = (t[:len(t) // 2] for t in (image, mask))
                out = ref_train.train_step(s, image, mask, q=q)
                losses.append({k: float(out[k]) for k in ("d_loss",
                                                          "g_loss")})
                if step == 0:
                    first = {
                        **{f"g.{k}": float(v / (1.0 - h.beta1)) for k, v in
                           norms(s.g_opt.m).items()},
                        **{f"d.{k}": float(v / (1.0 - h.beta1)) for k, v in
                           norms(s.d_opt.m).items()}}
                    vecs = {f"{tag}.{k}": v.cpu() / (1.0 - h.beta1)
                            for tag, opt in (("g", s.g_opt), ("d", s.d_opt))
                            for k, v in opt.m.items()} \
                        if run.params.get("keep_vectors") else {}
        changes = {
            **{f"g.{k}": v for k, v in norms(
                {k: s.g[k] - self.g0[k] for k in s.g}).items()},
            **{f"d.{k}": v for k, v in norms(
                {k: s.d[k] - self.d0[k] for k in s.d}).items()},
            **{f"ema.{k}": v for k, v in norms(
                {k: s.ema[k] - self.g0[k] for k in s.ema}).items()}}
        run.log(f"reference steps (q={getattr(q, '__name__', None)}, "
                f"half={half}) took {time.perf_counter() - t0:.2f} s")
        return {"losses": losses, "first": first, "changes": changes,
                "first_vecs": vecs}

    @staticmethod
    def compare(got: dict, ref: dict) -> dict:
        """The numbers compared: the worst relative gap of a step's D or
        G loss; the worst leaf's gap of first-gradient norms; the median
        leaf's gap of change norms after the three steps (leaves that
        move by round-off alone left out; an EMA leaf goes with its
        parameter). The worst leaf's change gap is logged, not compared:
        on sound runs it follows the bf16 error of that leaf's first
        gradient and reads within 3.3x of the float8 control's."""
        loss_gap = max(abs(g[k] - r[k]) / max(abs(r[k]), 1e-6)
                       for g, r in zip(got["losses"], ref["losses"])
                       for k in r)
        first = leaf_gaps(got["first"], ref["first"])
        change = leaf_gaps(got["changes"], ref["changes"], _keep(ref))
        return {"loss_gap": loss_gap,
                "grad_gap_worst": max(first.values()),
                "change_gap_median": float(np.median(list(change.values())))}

    def program_readings(self) -> dict:
        return {"losses": self.losses, "first": self.first,
                "changes": self.changes, "first_vecs": self.first_vecs}

    def readings(self, q=None) -> dict:
        """The compared numbers of the program's first steps against the
        reference's; with ``q`` the reference at that precision takes the
        program's place (the control)."""
        ref = self.reference()
        got = self.program_readings() if q is None else self.reference(q)
        keep = _keep(ref)
        for what, lg in (("first gradient", leaf_gaps(got["first"],
                                                      ref["first"])),
                         ("change", leaf_gaps(got["changes"], ref["changes"],
                                              keep))):
            worst = sorted(lg, key=lg.get)[-3:][::-1]
            self.run.log(f"worst leaves by {what}: "
                         + ", ".join(f"{k} {lg[k]:.4g}" for k in worst))
        self.run.log("losses (program, reference): " + "; ".join(
            f"{k} {g[k]:.6g} {r[k]:.6g}" for g, r in zip(got["losses"],
                                                         ref["losses"])
            for k in r))
        return self.compare(got, ref)

    def counts(self, record: dict) -> dict:
        """Model FLOPs and the attention backward's bound over the
        window's steps; the masks of each step drawn again by the
        reference's code."""
        cfg, run = self.cfg, self.run
        b, s = cfg.data.batch_size, cfg.data.image_size
        f = cfg.model.base_features
        first, steps = record["first_step"], record["steps"]
        r1 = record["r1_steps"]
        flops = (r1 * count.train_step_flops(self.h, b, s, True)
                 + (steps - r1) * count.train_step_flops(self.h, b, s, False))
        m = inputs.mask_params(cfg)
        bwd = 0.0
        for step in range(first, first + steps):
            gen = inputs.cpu_generator(run.seed, "train_masks", step)
            if cfg.data.random_flip:
                torch.rand((b,), generator=gen)
            mask = deepfill.rasterize(deepfill.sample_strokes(gen, m, s, s, b),
                                      s, s, run.device)
            nv = float(count.valid_keys(mask).sum())
            # two forwards (the fake, G's loss), one backward
            flops += 4 * count.attention_fwd_flops(s, 4 * f, nv)
            bwd += count.attention_bwd_bound_s(s, 4 * f, b, nv)
        return {"model_flops": flops, "attn_bwd_bound_s": bwd}
