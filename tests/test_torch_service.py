"""The port's serving tier (infer/service.py): the micro-batcher and its
HTTP front, held to the cases of the JAX package's service tests, against
direct ``inpaint_batch`` calls and against the JAX package's service."""

import base64
import dataclasses
import io
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gan_inpainting_tpu.configs.base import apply_overrides as j_overrides
from gan_inpainting_tpu.infer.inpaint import Inpainter as JInpainter
from gan_inpainting_tpu.infer.service import InpaintService as JService
from gan_inpainting_tpu.models.generator import (
    build_generator as j_build_generator,
)

from gan_inpainting_torch.configs.base import (
    apply_overrides,
    config_from_dict,
    get_config,
)
from gan_inpainting_torch.infer.inpaint import Inpainter, _bucket
from gan_inpainting_torch.infer.service import (
    InpaintService,
    ServiceOverloadedError,
    make_http_server,
)
from gan_inpainting_torch.io.convert import params_from_jax
from gan_inpainting_torch.models.generator import build_generator


@pytest.fixture(scope="module")
def inpainter():
    """The tiny port inpainter of tests/test_torch_inpaint.py."""
    cfg = apply_overrides(get_config("celebahq256_freeform"), [
        "model.base_features=8", "model.use_attention=true",
        "model.dtype_policy=f32", "infer.batch_buckets=1,4",
        "infer.size_buckets=32,64"])
    gen = build_generator(cfg.model, device="cpu", seed=3)
    return Inpainter(cfg, gen.state_dict(), device="cpu")


def _image(seed, size=32, w=None):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (size, w or size, 3), dtype=np.uint8)


def _mask(size=32, w=None):
    m = np.zeros((size, w or size), np.float32)
    q, qw = size // 4, (w or size) // 4
    m[q:-q, qw:-qw] = 1.0
    return m


class _Recorder:
    """Wraps an Inpainter: records each dispatch's batch size and bucket,
    optionally stalls it (``delay_s``) or blocks it until ``release``."""

    def __init__(self, inner, delay_s=0.0, block=False):
        self._inner = inner
        self._delay = delay_s
        self.cfg = inner.cfg
        self.batch_sizes = []
        self.started = threading.Event()
        self.release = threading.Event()
        if not block:
            self.release.set()

    def warmup(self):
        self._inner.warmup()

    def inpaint_batch(self, images, masks):
        self.batch_sizes.append(images.shape[0])
        self.started.set()
        assert self.release.wait(timeout=120)
        time.sleep(self._delay)
        return self._inner.inpaint_batch(images, masks)


def _hole_close(a, b, mask, frac=0.999):
    hole = np.broadcast_to(mask[..., None] > 0, a.shape)
    diff = np.abs(a.astype(int) - b.astype(int))[hole]
    return float((diff <= 1).mean()) >= frac


def _png_b64(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/inpaint", data=body,
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def test_concurrent_requests_coalesce_and_match_direct(inpainter):
    service = InpaintService(inpainter, max_wait_ms=200.0)
    try:
        n = 4
        imgs = [_image(i) for i in range(n)]
        mask = _mask()
        futures = [service.submit(img, mask) for img in imgs]
        outs = [f.result(timeout=120) for f in futures]
        direct = inpainter.inpaint_batch(np.stack(imgs),
                                         np.stack([mask] * n))
        for out, want, img in zip(outs, direct, imgs):
            np.testing.assert_array_equal(out, want)
            np.testing.assert_array_equal(out[mask == 0], img[mask == 0])
        assert service.stats["dispatches"] < n
        assert service.stats["requests"] == n
    finally:
        service.close()


def test_mixed_sizes_dispatch_per_bucket(inpainter):
    service = InpaintService(inpainter, max_wait_ms=200.0)
    try:
        img_s, img_l = _image(0, 32), _image(1, 64)
        f_s = service.submit(img_s, _mask(32))
        f_l = service.submit(img_l, _mask(64))
        out_s, out_l = f_s.result(timeout=120), f_l.result(timeout=120)
        assert out_s.shape == (32, 32, 3) and out_l.shape == (64, 64, 3)
        np.testing.assert_array_equal(out_s[_mask(32) == 0],
                                      img_s[_mask(32) == 0])
        np.testing.assert_array_equal(out_l[_mask(64) == 0],
                                      img_l[_mask(64) == 0])
        assert service.stats["dispatches"] == 2
    finally:
        service.close()


def test_submit_validates_shapes(inpainter):
    service = InpaintService(inpainter)
    try:
        with pytest.raises(ValueError, match="mask shape"):
            service.submit(_image(0, 32), _mask(64))
        with pytest.raises(ValueError, match="image must be"):
            service.submit(np.zeros((32, 32), np.uint8), _mask(32))
        with pytest.raises(ValueError, match="bucket"):
            service.submit(_image(0, 96), _mask(96))
        assert service.stats["inflight"] == 0
    finally:
        service.close()


def test_http_front_roundtrip(inpainter):
    service = InpaintService(inpainter, max_wait_ms=20.0)
    server = make_http_server(service, port=0)     # ephemeral port
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        img = _image(5)
        # an anti-aliased grey mask: > 127 is the hole
        mask_u8 = (_mask() * 200).astype(np.uint8)
        mask_u8[0, 0] = 100
        body = json.dumps({"image": _png_b64(img),
                           "mask": _png_b64(mask_u8)}).encode()
        with _post(port, body) as resp:
            payload = json.loads(resp.read())
        from PIL import Image

        out = np.asarray(Image.open(
            io.BytesIO(base64.b64decode(payload["output"]))))
        np.testing.assert_array_equal(out, inpainter(img, _mask()))

        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["ok"] and health["requests"] == 1

        no_mask = json.dumps({"image": _png_b64(img)}).encode()
        for bad in (b"not json", no_mask):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(port, bad)
            assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                   timeout=30)
        assert err.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def test_burst_larger_than_largest_bucket(inpainter):
    """14 same-size requests pile up behind a stalled dispatch: every group
    stays within the largest batch bucket (4) and every request resolves."""
    slow = _Recorder(inpainter, delay_s=0.2)
    service = InpaintService(slow, max_wait_ms=1.0)
    try:
        imgs = [_image(i) for i in range(14)]
        mask = _mask()
        futures = [service.submit(img, mask) for img in imgs]
        outs = [f.result(timeout=300) for f in futures]
        direct = inpainter.inpaint_batch(np.stack(imgs[:4]),
                                         np.stack([mask] * 4))
        for out, want in zip(outs[:4], direct):
            assert _hole_close(out, want, mask)
        for out, img in zip(outs, imgs):
            np.testing.assert_array_equal(out[mask == 0], img[mask == 0])
        assert all(n <= 4 for n in slow.batch_sizes), slow.batch_sizes
        assert sum(slow.batch_sizes) == 14
    finally:
        service.close()


def test_mixed_size_storm(inpainter):
    """Concurrent submitters over both size buckets (and a non-square size)
    with a short switch interval: every request resolves with its own
    shape and bit-exact known pixels, and the counts add up."""
    service = InpaintService(inpainter, max_wait_ms=5.0)
    results, errors = {}, []
    sizes = [(32, 32), (64, 64), (24, 40)]

    def worker(i):
        h, w = sizes[i % 3]
        img, mask = _image(i, h, w), _mask(h, w)
        try:
            out = service.submit(img, mask).result(timeout=300)
            results[i] = (out.shape == (h, w, 3)
                          and np.array_equal(out[mask == 0], img[mask == 0]))
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errors.append((i, e))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert len(results) == 24 and all(results.values())
        st = service.stats
        assert st["requests"] == 24 and st["inflight"] == 0
        assert st["dispatches"] <= 24
        assert st["latency_p99_ms"] >= st["latency_p50_ms"] > 0
    finally:
        sys.setswitchinterval(switch)
        service.close()


def test_backpressure_sheds_load(inpainter):
    slow = _Recorder(inpainter, delay_s=0.2)
    service = InpaintService(slow, max_wait_ms=1.0, max_queue=4)
    try:
        mask = _mask()
        futures = []
        with pytest.raises(ServiceOverloadedError):
            for i in range(50):
                futures.append(service.submit(_image(i), mask))
        assert len(futures) >= 4          # admitted up to the bound
        for f in futures:
            assert f.result(timeout=300).shape == (32, 32, 3)
        assert service.stats["rejected"] >= 1
        assert service.stats["inflight"] == 0
        # once the backlog drains, admission reopens
        assert service.submit(_image(99), mask).result(
            timeout=300).shape == (32, 32, 3)
    finally:
        service.close()


def test_http_429_when_overloaded(inpainter):
    slow = _Recorder(inpainter, block=True)
    service = InpaintService(slow, max_wait_ms=1.0, max_queue=2)
    server = make_http_server(service, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        mask = _mask()
        futures = [service.submit(_image(i), mask) for i in range(2)]
        body = json.dumps({"image": _png_b64(_image(9)),
                           "mask": _png_b64((mask * 255).astype(np.uint8))
                           }).encode()
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            _post(port, body)
        assert exc_info.value.code == 429
        assert exc_info.value.headers["Retry-After"] == "1"
        slow.release.set()
        for f in futures:
            f.result(timeout=300)
    finally:
        slow.release.set()
        server.shutdown()
        server.server_close()
        service.close()


def test_close_fails_pending_futures(inpainter):
    """A full dispatch stalls; behind it wait a 64² request and a 32² one.
    close() lets the head (64²) batch run and fails the deferred 32²
    request with "service closed"; submit() then refuses."""
    slow = _Recorder(inpainter, block=True)
    service = InpaintService(slow, max_batch=2, max_wait_ms=60_000.0)
    head = [service.submit(_image(i), _mask()) for i in range(2)]
    assert slow.started.wait(timeout=60)
    big = service.submit(_image(2, 64), _mask(64))
    small = service.submit(_image(3), _mask())
    closer = threading.Thread(target=service.close)
    closer.start()
    deadline = time.monotonic() + 60
    while service._queue.qsize() < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    slow.release.set()
    closer.join(timeout=120)
    assert not closer.is_alive()
    for f in head:
        assert f.result(timeout=1).shape == (32, 32, 3)
    assert big.result(timeout=1).shape == (64, 64, 3)
    with pytest.raises(RuntimeError, match="service closed"):
        small.result(timeout=1)
    assert slow.batch_sizes == [2, 1]
    assert service.stats["inflight"] == 0
    with pytest.raises(RuntimeError, match="service is closed"):
        service.submit(_image(4), _mask())


def test_service_matches_direct_calls(inpainter):
    """Each request's output equals inpaint_batch of the requests of its
    size: bit-exact where its dispatch ran the same batch bucket, else
    within ±1 on ≥ 99.9 % of hole pixels; known pixels bit-exact."""
    rec = _Recorder(inpainter)
    service = InpaintService(rec, max_wait_ms=50.0)
    sizes = [(32, 32)] * 3 + [(64, 64)] * 2 + [(24, 40)] * 2
    reqs = [(_image(10 + i, h, w), _mask(h, w))
            for i, (h, w) in enumerate(sizes)]
    dispatch_bucket = {}
    orig = rec.inpaint_batch

    def recording(images, masks):
        out = orig(images, masks)
        for row in range(images.shape[0]):
            dispatch_bucket[images[row].tobytes()] = _bucket(
                images.shape[0], inpainter.cfg.infer.batch_buckets)
        return out

    rec.inpaint_batch = recording
    try:
        futures = [service.submit(img, m) for img, m in reqs]
        outs = [f.result(timeout=300) for f in futures]
    finally:
        service.close()
    buckets = inpainter.cfg.infer.batch_buckets
    for shape in set(sizes):
        idx = [i for i, s in enumerate(sizes) if s == shape]
        direct = inpainter.inpaint_batch(np.stack([reqs[i][0] for i in idx]),
                                         np.stack([reqs[i][1] for i in idx]))
        for k, i in enumerate(idx):
            img, mask = reqs[i]
            np.testing.assert_array_equal(outs[i][mask == 0], img[mask == 0])
            sb = _bucket(max(shape), inpainter.cfg.infer.size_buckets)
            padded = np.zeros((sb, sb, 3), np.uint8)
            padded[:shape[0], :shape[1]] = img
            if dispatch_bucket[padded.tobytes()] == _bucket(len(idx), buckets):
                np.testing.assert_array_equal(outs[i], direct[k])
            else:
                assert _hole_close(outs[i], direct[k], mask)
    assert len(rec.batch_sizes) < len(reqs)


def test_service_matches_jax_service(tiny_config):
    """The same params (carried by params_from_jax) through both packages'
    services: uint8 within ±1 on ≥ 99.9 % of pixels."""
    jcfg = j_overrides(tiny_config, ["infer.batch_buckets=1,4,8",
                                     "infer.size_buckets=32,64"])
    shapes = jax.eval_shape(
        j_build_generator(jcfg.model).init, jax.random.key(0),
        jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 32, 32, 1)))["params"]
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape)
                   / np.sqrt(max(np.prod(s.shape[:-1]), 1))).astype(
                       np.float32), shapes)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    services = (JService(JInpainter(jcfg, params), max_wait_ms=50.0),
                InpaintService(Inpainter(cfg, params_from_jax(params),
                                         device="cpu"), max_wait_ms=50.0))
    sizes = [32, 32, 64, 32, 64, 48]
    reqs = [(_image(20 + i, s), _mask(s)) for i, s in enumerate(sizes)]
    try:
        outs = [[f.result(timeout=300) for f in
                 [svc.submit(img, m) for img, m in reqs]]
                for svc in services]
    finally:
        for svc in services:
            svc.close()
    for (img, mask), want, got in zip(reqs, *outs):
        np.testing.assert_array_equal(got[mask == 0], img[mask == 0])
        diff = np.abs(got.astype(int) - want.astype(int))
        assert float((diff <= 1).mean()) >= 0.999, diff.max()


def test_packed_weights_cache_is_shared_across_threads(monkeypatch):
    """The gated-conv kernels' weight cache, reached from the service's
    dispatcher thread and from callers: one pack per weight and layout."""
    import torch

    from gan_inpainting_torch.ops.kernels import gated_matmul as gm

    calls = []
    real = gm.pack_weights

    def counting(weight, p):
        calls.append(threading.get_ident())
        time.sleep(0.01)
        return real(weight, p)

    monkeypatch.setattr(gm, "pack_weights", counting)
    weight = torch.nn.Parameter(torch.randn(2 * 24, 48, 3, 3))
    plan = gm.plan(48, 24, torch.bfloat16)
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        gm.packed_weights(weight, plan, torch.bfloat16))) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 8 and len(calls) == 1
    assert all(g is got[0] for g in got)


class _Warming(_Recorder):
    """A recorder whose warmup() records the thread it ran on, or fails."""

    def __init__(self, inner, fail=False):
        super().__init__(inner)
        self.fail = fail
        self.warmed_on = []

    def warmup(self):
        self.warmed_on.append(threading.current_thread().name)
        assert self.release.wait(timeout=120)
        if self.fail:
            raise RuntimeError("warmup broke")
        self._inner.warmup()


def test_warmup_runs_on_the_dispatcher_thread(inpainter):
    """cuDNN keeps its tuned plans per thread: the service warms the
    buckets on the thread that dispatches, before the first dispatch."""
    warm = _Warming(inpainter)
    service = InpaintService(warm, max_wait_ms=1.0)
    try:
        service.ready(timeout=120)
        assert warm.warmed_on == ["inpaint-dispatch"]
        assert warm.batch_sizes == []     # warmup is not a dispatch
        out = service.submit(_image(30), _mask()).result(timeout=120)
        np.testing.assert_array_equal(out, inpainter(_image(30), _mask()))
        assert warm.warmed_on == ["inpaint-dispatch"]
    finally:
        service.close()


def test_failed_warmup_fails_ready_and_every_request(inpainter):
    """A warmup that raises is not swallowed: ready() raises from it and
    every request, queued before or after, fails with it undispatched."""
    warm = _Warming(inpainter, fail=True)
    warm.release.clear()                  # hold the warmup's thread back
    early = None
    service = InpaintService(warm, max_wait_ms=1.0)
    try:
        early = service.submit(_image(32), _mask())
        warm.release.set()
        with pytest.raises(RuntimeError, match="warmup failed") as exc_info:
            service.ready(timeout=120)
        assert "warmup broke" in str(exc_info.value.__cause__)
        late = service.submit(_image(33), _mask())
        for f in (early, late):
            with pytest.raises(RuntimeError, match="warmup failed") as e:
                f.result(timeout=120)
            assert "warmup broke" in str(e.value.__cause__)
        assert warm.batch_sizes == []
        assert service.stats["inflight"] == 0
    finally:
        service.close()
