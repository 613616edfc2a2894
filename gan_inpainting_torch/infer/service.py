"""Batched inpainting service: a micro-batcher and an HTTP front.

Two tiers on top of :class:`~gan_inpainting_torch.infer.inpaint.Inpainter`,
with the JAX package's semantics:

* :class:`InpaintService` — a dynamic micro-batcher. Concurrent callers
  submit single (image, mask) requests; a dispatcher thread coalesces the
  queue into one ``inpaint_batch`` call per size bucket (up to
  ``max_batch``, waiting at most ``max_wait_ms`` for stragglers), so the
  card sees large batches while callers keep a single-request API.
* :func:`make_http_server` / :func:`serve` — a minimal stdlib HTTP front
  (JSON with base64 PNG bodies) for the ``serve`` CLI subcommand.

Requests inside one dispatch share a size bucket (one of the Inpainter's
fixed shapes): the dispatcher takes the queue head's bucket and leaves
other sizes for the next cycle, in arrival order. Dispatch groups are
capped at ``max_batch`` and oversize groups are chunked, so no group
outgrows the largest batch bucket. Admission is bounded: beyond
``max_queue`` requests in flight ``submit`` raises
:class:`ServiceOverloadedError` (HTTP 429 at the front).

On the card the dispatcher thread runs its work under
``torch.cuda.device`` of the Inpainter's card: a new thread's current
device is 0, and the eager ops and cuDNN convs between the kernels follow
the current device. ``torch.inference_mode``, which is thread-local, is
entered inside the forward itself (``make_forward_fn``). PyTorch keeps
cuDNN's tuned convolution plans (``cudnn.benchmark``) per thread, so an
``Inpainter.warmup()`` on another thread would leave the dispatcher to
tune every conv shape again at its first request of each bucket. The
dispatcher thread therefore runs ``Inpainter.warmup()`` itself before its
first dispatch; requests submitted meanwhile wait in the queue.
:meth:`InpaintService.ready` waits for that warmup and raises its error;
after a failed warmup every request fails with it.

An Inpainter over several cards runs each shard on its replica's own
worker thread, under that replica's card: the dispatcher's warmup then
tunes every replica on the thread that will serve it, and waits for all
of them; ``ready()`` raises the first replica's error.
"""

from __future__ import annotations

import base64
import collections
import contextlib
import io
import json
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from gan_inpainting_torch.infer.inpaint import (
    Inpainter,
    _bucket,
    device_scope,
)


class ServiceOverloadedError(RuntimeError):
    """Raised by submit() when max_queue requests are already in flight."""


@dataclass
class _Request:
    image: np.ndarray          # (H, W, 3) uint8
    mask: np.ndarray           # (H, W, 1) float32
    bucket: int                # size bucket this request pads to
    future: Future
    t_submit: float = field(default_factory=time.perf_counter)


def _device_scope(inpainter):
    """``torch.cuda.device`` of the Inpainter's (first) card, resolved in
    the calling thread; a null context off the card."""
    device = getattr(inpainter, "device", None)
    if device is None:
        return contextlib.nullcontext()
    return device_scope(torch.device(device))


class InpaintService:
    """Thread-safe dynamic batcher over an :class:`Inpainter`."""

    def __init__(self, inpainter: Inpainter, *, max_batch: int | None = None,
                 max_wait_ms: float = 5.0, max_queue: int | None = None):
        self._inpainter = inpainter
        # set once the dispatcher thread's warmup has finished; the error
        # it raised, if any, fails ready() and every request
        self._warmed = threading.Event()
        self._warmup_error: Exception | None = None
        icfg = inpainter.cfg.infer
        self._max_batch = (max(icfg.batch_buckets) if max_batch is None
                           else max_batch)
        self._max_wait = max_wait_ms / 1e3
        # admission bound: beyond this many in-flight requests submit()
        # raises ServiceOverloadedError (default: 8 full batches of backlog)
        self._max_queue = (8 * self._max_batch if max_queue is None
                           else max_queue)
        self._queue: queue.Queue[_Request | None] = queue.Queue()
        self._dispatch_count = 0      # forwarded batches
        self._request_count = 0
        self._rejected_count = 0
        self._inflight = 0            # submitted, future not yet resolved
        self._lock = threading.Lock()
        # the last 4096 end-to-end request latencies (seconds)
        self._latencies: collections.deque[float] = collections.deque(
            maxlen=4096)
        self._closed = False
        self._device_scope = _device_scope(inpainter)
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="inpaint-dispatch", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, image, mask) -> Future:
        """Enqueue one request; resolves to the (H, W, 3) uint8 result.

        Raises :class:`ServiceOverloadedError` when ``max_queue`` requests
        are in flight (retry with backoff; the HTTP front answers 429)."""
        if self._closed:
            raise RuntimeError("service is closed")
        image = np.asarray(image, np.uint8)
        mask = np.asarray(mask, np.float32)
        if mask.ndim == 2:
            mask = mask[..., None]
        if image.ndim != 3 or image.shape[-1] != 3:
            raise ValueError(f"image must be (H, W, 3) uint8, got "
                             f"{image.shape}")
        if mask.shape[:2] != image.shape[:2]:
            raise ValueError(f"mask shape {mask.shape[:2]} does not match "
                             f"image {image.shape[:2]}")
        bucket = _bucket(max(image.shape[:2]),
                         self._inpainter.cfg.infer.size_buckets)
        with self._lock:
            if self._inflight >= self._max_queue:
                self._rejected_count += 1
                raise ServiceOverloadedError(
                    f"{self._inflight} requests in flight (max_queue="
                    f"{self._max_queue}); retry with backoff")
            self._inflight += 1
        fut: Future = Future()
        self._queue.put(_Request(image, mask, bucket, fut))
        return fut

    def _finish(self, req: _Request, result=None,
                exc: Exception | None = None):
        with self._lock:
            self._inflight -= 1
            if exc is None:
                self._latencies.append(time.perf_counter() - req.t_submit)
        if exc is None:
            req.future.set_result(result)
        else:
            req.future.set_exception(exc)

    def ready(self, timeout: float | None = None) -> None:
        """Block until the dispatcher thread has warmed every bucket.
        Raises ``RuntimeError`` (from the warmup's own error) if the warmup
        failed, ``TimeoutError`` if it is still running after ``timeout``
        seconds."""
        if not self._warmed.wait(timeout):
            raise TimeoutError(f"service warmup still running after "
                               f"{timeout} s")
        if self._warmup_error is not None:
            raise RuntimeError("service warmup failed") from (
                self._warmup_error)

    def inpaint(self, image, mask) -> np.ndarray:
        """Blocking single-request API."""
        return self.submit(image, mask).result()

    def close(self):
        """Stop admitting, finish the dispatch under way and fail the
        requests still waiting with ``RuntimeError("service closed")``."""
        self._closed = True
        self._queue.put(None)
        self._thread.join()

    @property
    def stats(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)
            out = {"requests": self._request_count,
                   "dispatches": self._dispatch_count,
                   "inflight": self._inflight,
                   "rejected": self._rejected_count}
        if lat:
            out["latency_p50_ms"] = 1e3 * lat[len(lat) // 2]
            out["latency_p99_ms"] = 1e3 * lat[min(len(lat) - 1,
                                                  int(0.99 * len(lat)))]
        return out

    # ------------------------------------------------------------------
    def _dispatch_loop(self):
        with self._device_scope:
            try:
                self._inpainter.warmup()
            except Exception as e:  # noqa: BLE001 — raised by ready() and
                # handed to every request
                self._warmup_error = e
            finally:
                self._warmed.set()
            self._dispatch()

    def _dispatch(self):
        pending: collections.deque[_Request] = collections.deque()
        while True:
            # block for the first request (or shutdown)
            if not pending:
                item = self._queue.get()
                if item is None:
                    return
                pending.append(item)
            # coalesce the head's size bucket up to max_batch; other
            # buckets (and same-bucket overflow) wait for the next cycle
            bucket = pending[0].bucket
            batch: list[_Request] = []
            deferred: collections.deque[_Request] = collections.deque()
            while pending and len(batch) < self._max_batch:
                r = pending.popleft()
                (batch if r.bucket == bucket else deferred).append(r)
            # straggler wait only while the batch has room
            t0 = time.perf_counter()
            while len(batch) < self._max_batch:
                remaining = self._max_wait - (time.perf_counter() - t0)
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    self._run_batch(batch)
                    for r in (*deferred, *pending):
                        self._finish(r, exc=RuntimeError("service closed"))
                    return
                (batch if item.bucket == bucket else deferred).append(item)
            self._run_batch(batch)
            deferred.extend(pending)    # deferred items arrived first
            pending = deferred

    def _run_batch(self, batch: list[_Request]):
        # the dispatch loop caps groups at max_batch; chunk anyway so an
        # oversize group never reaches _bucket (which would fail them all)
        for start in range(0, len(batch), self._max_batch):
            self._run_chunk(batch[start:start + self._max_batch])

    def _run_chunk(self, batch: list[_Request]):
        if not batch:
            return
        if self._warmup_error is not None:
            exc = RuntimeError("service warmup failed")
            exc.__cause__ = self._warmup_error
            for r in batch:
                self._finish(r, exc=exc)
            return
        sb = batch[0].bucket
        n = len(batch)
        images = np.zeros((n, sb, sb, 3), np.uint8)
        masks = np.zeros((n, sb, sb, 1), np.float32)
        for i, r in enumerate(batch):
            h, w = r.image.shape[:2]
            images[i, :h, :w] = r.image
            masks[i, :h, :w] = r.mask
        try:
            out = self._inpainter.inpaint_batch(images, masks)
        except Exception as e:  # noqa: BLE001 — each request gets the error
            for r in batch:
                self._finish(r, exc=e)
            return
        with self._lock:
            self._dispatch_count += 1
            self._request_count += n
        for i, r in enumerate(batch):
            h, w = r.image.shape[:2]
            self._finish(r, result=out[i, :h, :w])


# ---------------------------------------------------------------------------
# Minimal HTTP front (stdlib only)
# ---------------------------------------------------------------------------


def _png_decode(b64: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def _png_encode(arr: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def make_http_server(service: InpaintService, host: str = "127.0.0.1",
                     port: int = 8763):
    """HTTP front: ``POST /inpaint`` ``{"image": <b64 png>, "mask": <b64
    png>}`` → ``{"output": <b64 png>}`` (mask > 127 is a hole); ``GET
    /healthz`` → the service's stats. 429 with ``Retry-After: 1`` when the
    service is overloaded, 400 on a bad body. Returns the (unstarted)
    ``http.server.ThreadingHTTPServer``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):   # quiet by default
            pass

        def _json(self, code: int, payload: dict, headers=()):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, **service.stats})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/inpaint":
                self._json(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length))
                image = _png_decode(req["image"])
                mask = _png_decode(req["mask"])
                if mask.ndim == 3:
                    mask = mask[..., 0]
                out = service.inpaint(image, (mask > 127).astype(np.float32))
                self._json(200, {"output": _png_encode(out)})
            except ServiceOverloadedError as e:
                self._json(429, {"error": str(e)},
                           headers=(("Retry-After", "1"),))
            except Exception as e:      # noqa: BLE001 — HTTP boundary
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def serve(inpainter: Inpainter, host: str = "127.0.0.1",
          port: int = 8763, *, max_wait_ms: float = 5.0,
          max_queue: int | None = None):
    """Blocking entry point of the ``serve`` CLI subcommand. The caller
    builds the :class:`Inpainter` (from a checkpoint, the best slot, or an
    exported npz). The port opens once the service has warmed every bucket
    on its dispatcher thread; a failed warmup raises here."""
    cfg = inpainter.cfg
    service = InpaintService(inpainter, max_wait_ms=max_wait_ms,
                             max_queue=max_queue)
    try:
        service.ready()
    except BaseException:
        service.close()
        raise
    server = make_http_server(service, host, port)
    print(f"[serve] inpaint service on http://{host}:{port} "
          f"(config {cfg.name}, buckets {cfg.infer.size_buckets}, "
          f"replicas on {', '.join(map(str, inpainter.devices))}, "
          f"model axis {cfg.train.mesh.model}, spatial axis "
          f"{getattr(inpainter, 'spatial', 1)})",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.close()
