"""Batch serving: ``Inpainter.inpaint_batch`` called back to back, each
call ``batch`` distinct images of ``size``² with free-form masks, as host
arrays (as a folder job passes them), cycling over a pool of
``pool_batches`` batches made from the seed.

Parameters: ``batch``, ``size``, ``pool_batches``, ``warm_calls``,
``check_batches`` (how many of the pool's batches, drawn from the seed,
are compared after the window: each one's latest output in the window),
``ref_block`` (images per block of the reference).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import count, inputs, serving


class Driver:
    def __init__(self, run):
        self.run = run
        p = run.params
        self.batch, self.size = int(p["batch"]), int(p["size"])
        self.n_pool = int(p["pool_batches"])

    def setup(self) -> None:
        run = self.run
        self.cfg, self.params, self.inp = serving.build(run)
        imgs, msks = serving.pool(run, self.cfg, self.n_pool * self.batch,
                                  self.size, "serve_batch")
        self.imgs = imgs.reshape(self.n_pool, self.batch, *imgs.shape[1:])
        self.masks = msks.reshape(self.n_pool, self.batch, *msks.shape[1:])
        for i in range(int(run.params["warm_calls"])):
            self.inp.inpaint_batch(self.imgs[i % self.n_pool],
                                   self.masks[i % self.n_pool])

    def measure(self) -> dict:
        run, tracer = self.run, self.run.tracer
        outputs, calls = {}, 0
        with tracer.window():
            t0 = time.perf_counter()
            while True:
                slot = calls % self.n_pool
                with tracer.span("inpaint_batch"):
                    outputs[slot] = self.inp.inpaint_batch(self.imgs[slot],
                                                           self.masks[slot])
                calls += 1
                if time.perf_counter() - t0 >= run.seconds:
                    break
            t1 = time.perf_counter()
        self.outputs = outputs
        return {"seconds": t1 - t0, "images": calls * self.batch,
                "calls": calls, "attempted": calls * self.batch,
                "failed": 0}

    def release(self) -> None:
        serving.free(self.inp)
        self.inp = None

    def compared(self):
        """(images, masks, served images) of the batches the check draws
        from the seed among those served in the window."""
        run = self.run
        rng = np.random.default_rng(inputs.derive(run.seed, "check"))
        slots = sorted(rng.choice(sorted(self.outputs),
                                  size=min(int(run.params["check_batches"]),
                                           len(self.outputs)),
                                  replace=False).tolist())
        return (np.concatenate([self.imgs[s] for s in slots]),
                np.concatenate([self.masks[s] for s in slots]),
                np.concatenate([self.outputs[s] for s in slots]))

    def readings(self, q=None) -> dict:
        imgs, masks, got = self.compared()
        return serving.readings(self, imgs, masks, got, q)

    def counts(self, record: dict) -> dict:
        """Model FLOPs and the attention forward's bound over the window's
        calls (the pool's batches in call order)."""
        f = self.cfg.model.base_features
        per_image = serving.image_flops(
            f, self.size, self.masks.reshape(-1, *self.masks.shape[2:]))
        per_slot = per_image.reshape(self.n_pool, self.batch).sum(1)
        attn_ops, attn_bytes = [], []
        for s in range(self.n_pool):
            nv = float(count.valid_keys(torch.from_numpy(self.masks[s])).sum())
            attn_ops.append(count.attention_fwd_flops(self.size, 4 * f, nv))
            attn_bytes.append(count.attention_fwd_bytes(self.size, 4 * f,
                                                        self.batch))
        calls = record["calls"]
        slots = [c % self.n_pool for c in range(calls)]
        return {
            "model_flops": float(sum(per_slot[s] for s in slots)),
            "attn_fwd_bound_s": float(sum(count.bound_s(attn_bytes[s],
                                                        attn_ops[s])
                                          for s in slots)),
        }
