"""The program's spans and its host-sync counter (utils/spans.py): the
recorder, the null path, the transfer helper, the spans of the batch
build, the train step and the serve call, the device trace's idle gaps
charged to a program span, and, on the card, the counter against the
syncs PyTorch's sync debug mode reports.

CPU: ``python -m pytest tests/test_torch_spans.py -q``; the card:
``python -m pytest --noconftest -m gpu tests/test_torch_spans.py``.
"""

import threading
import warnings

import numpy as np
import pytest
import torch

from gan_inpainting_torch.configs.base import apply_overrides, get_config
from gan_inpainting_torch.data.pipeline import make_train_batch
from gan_inpainting_torch.parallel.sharding import counts
from gan_inpainting_torch.utils import spans
from gan_inpainting_torch.utils.spans import (
    SpanRecorder,
    section,
    set_section_hook,
    transfer,
)

TRAIN_TINY = ["model.base_features=8", "model.disc_features=8",
              "data.image_size=32", "data.batch_size=2"]


@pytest.fixture()
def recorder():
    rec = SpanRecorder()
    set_section_hook(rec)
    yield rec
    set_section_hook(None)


def _by_name(rec):
    return {s.name: s for s in rec.spans}


def test_recorder_nests_names_threads_and_reads_time_ns(recorder,
                                                        monkeypatch):
    ticks = iter(range(1000, 10**6, 10))
    monkeypatch.setattr(spans.time, "time_ns", lambda: next(ticks))

    def worker():
        with section("inpaint.forward"):
            pass

    with section("outer"):
        with section("inner"):
            pass
        t = threading.Thread(target=worker, name="replica-1")
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    got = _by_name(recorder)
    assert set(got) == {"outer", "inner", "inpaint.forward"}
    assert got["inner"].parent == "outer" and got["outer"].parent is None
    # a span on another thread has no parent from this one
    assert got["inpaint.forward"].parent is None
    assert got["inpaint.forward"].thread == "replica-1"
    assert got["outer"].thread == threading.current_thread().name
    # every stamp came from time.time_ns, in order
    assert got["outer"].t0 < got["inner"].t0 < got["inner"].t1 \
        < got["outer"].t1
    assert all(s.t0 >= 1000 and s.t0 % 10 == 0 for s in recorder.spans)
    assert sorted(recorder.intervals()) == sorted(
        (s.t0, s.t1, s.name) for s in recorder.spans)


def test_recorder_takes_spans_from_many_threads_at_once(recorder):
    def worker(i):
        for _ in range(200):
            with section(f"w{i}"):
                with section(f"w{i}.inner"):
                    pass

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    s = recorder.summary()["spans"]
    assert {k: v["count"] for k, v in s.items()} == {
        **{f"w{i}": 200 for i in range(4)},
        **{f"w{i}.inner": 200 for i in range(4)}}
    assert all(sp.parent == sp.name[:2] for sp in recorder.spans
               if sp.name.endswith(".inner"))


def test_no_hook_records_nothing_and_makes_no_cuda_event(monkeypatch):
    set_section_hook(None)
    rec = SpanRecorder(events=True)          # made, never installed

    def no_event(*a, **k):
        raise AssertionError("a CUDA event was made")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    ctx = section("batch")
    assert ctx is section("g_forward") is spans._NULL
    with ctx:
        with section("d_step"):
            pass
    assert rec.spans == [] and rec.intervals() == []
    assert rec.summary()["spans"] == {}


def test_transfer_counts_host_syncs_and_opens_its_span(recorder):
    before = dict(counts)
    x = torch.ones(3, 4)
    # the host to another device (meta stands in for the card here)
    with section("batch"):
        y = transfer(x, "meta")
    assert y.device.type == "meta" and y.shape == x.shape
    assert counts["host_syncs"] - before["host_syncs"] == 1
    assert counts["host_sync_bytes"] - before["host_sync_bytes"] == 48
    # no crossing between host and device: no count, no span
    assert transfer(x, "cpu") is x
    assert counts["host_syncs"] - before["host_syncs"] == 1
    got = _by_name(recorder)
    assert set(got) == {"batch", "sync.h2d"}
    assert got["sync.h2d"].parent == "batch"
    sync_ns = got["sync.h2d"].t1 - got["sync.h2d"].t0
    assert got["batch"].sync_ns == sync_ns
    assert sorted(n for _, _, n in recorder.intervals()) == [
        "batch", "batch:sync.h2d"]
    summary = recorder.summary()
    b = summary["spans"]["batch"]
    assert b["net_of_sync_s"] == pytest.approx(b["host_s"] - sync_ns / 1e9)
    assert summary["counts"] == {"host_syncs": 1, "host_sync_bytes": 48}


def test_batch_build_spans(recorder):
    cfg = apply_overrides(get_config("places512_deepfill"), TRAIN_TINY)
    images = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8)
    make_train_batch(images, torch.Generator().manual_seed(0), cfg.mask,
                     flip=True)
    got = _by_name(recorder)
    assert set(got) == {"batch", "batch.flip", "batch.mask_draw",
                        "batch.rasterize"}
    assert all(got[k].parent == "batch" for k in got if k != "batch")
    assert [s.name for s in sorted(recorder.spans)] == [
        "batch", "batch.flip", "batch.mask_draw", "batch.rasterize"]


def test_train_step_phases(recorder):
    from gan_inpainting_torch.train.state import create_state
    from gan_inpainting_torch.train.step import make_train_step

    cfg = apply_overrides(get_config("places512_deepfill"), TRAIN_TINY)
    state = create_state(cfg, device="cpu")
    step = make_train_step(cfg)
    images = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8)
    batch = make_train_batch(images, torch.Generator().manual_seed(0),
                             cfg.mask, flip=True)
    recorder.spans.clear()
    step(state, batch)                       # step 0 takes lazy R1
    step(state, batch)
    n = recorder.summary()["spans"]
    assert {k: v["count"] for k, v in n.items()} == {
        "g_forward_detached": 2, "d_step": 2, "r1": 1, "d_optimizer": 2,
        "g_forward": 2, "g_backward": 2, "g_optimizer": 2, "ema": 2}
    assert {s.parent for s in recorder.spans if s.name == "r1"} == {"d_step"}
    assert {s.parent for s in recorder.spans if s.name != "r1"} == {None}


def test_inpaint_batch_spans(recorder):
    from gan_inpainting_torch.infer.inpaint import Inpainter
    from gan_inpainting_torch.models.generator import build_generator

    cfg = apply_overrides(get_config("serve_v4_8"), [
        "model.base_features=8", "model.dtype_policy=f32",
        "infer.batch_buckets=4", "infer.size_buckets=32"])
    gen = build_generator(cfg.model, device="cpu", seed=3)
    inp = Inpainter(cfg, gen.state_dict(), device="cpu")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (3, 30, 32, 3), dtype=np.uint8)
    msk = (rng.random((3, 30, 32)) < 0.3).astype(np.float32)
    recorder.spans.clear()
    out = inp.inpaint_batch(img, msk)
    assert out.shape == img.shape
    assert [s.name for s in sorted(recorder.spans)] == [
        "inpaint.prepare", "inpaint.h2d", "inpaint.forward", "inpaint.d2h",
        "inpaint.crop"]
    assert {s.parent for s in recorder.spans} == {None}
    inp.close()


class _Event:
    def __init__(self, name, start, end):
        self._n, self._s, self._d = name, start, end - start

    def name(self):
        return self._n

    def device_type(self):
        return torch.autograd.DeviceType.CUDA

    def is_user_annotation(self):
        return False

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_device_trace_charges_idle_to_the_program_span_inside_the_harness_span():
    """The harness's ``summarize`` given its own spans and the recorder's
    intervals: a gap inside ``batch_build`` while ``batch.rasterize`` is
    open goes to ``batch.rasterize``; one while only the harness's span is
    open goes to it; the busy and window seconds are as without."""
    from benchmark.harness import trace

    off = 1_000_000
    fill = "vectorized_elementwise_kernel<4, FillFunctor<float>>"
    events = [_Event(fill, off + 100, off + 101),
              _Event("k1", off + 1000, off + 3000),
              _Event("k2", off + 5000, off + 8000),
              _Event("k3", off + 9000, off + 11000)]
    prof = type("P", (), {})()
    prof.profiler = type("Q", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda self:
                                                  events})()
    harness = [(1000, 9000, "batch_build"), (9000, 11000, "step_dispatch")]
    rec = SpanRecorder()
    rec.spans = [spans.Span(3000, 4500, "batch", None, "MainThread", 0),
                 spans.Span(3500, 4500, "batch.rasterize", "batch",
                            "MainThread", 0)]
    base = trace.summarize(prof, 100, (1000, 11000), harness)
    s = trace.summarize(prof, 100, (1000, 11000),
                        harness + rec.intervals())
    # gaps: 3000-5000 (middle 4000, in batch.rasterize), 8000-9000
    # (middle 8500, batch_build alone)
    assert s["idle_by_span_s"] == {"batch.rasterize": 2000 / 1e9,
                                   "batch_build": 1000 / 1e9}
    assert base["idle_by_span_s"] == {"batch_build": 3000 / 1e9}
    assert {k: s[k] for k in ("busy_s", "window_s", "kernels_s")} == {
        k: base[k] for k in ("busy_s", "window_s", "kernels_s")}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _syncs(fn):
    """(host_syncs counted, the sync warnings) over one call of ``fn``,
    under ``torch.cuda.set_sync_debug_mode("warn")``."""
    torch.cuda.synchronize()
    before = counts["host_syncs"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    found = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    return counts["host_syncs"] - before, found


@pytest.mark.gpu
def test_host_syncs_equal_the_syncs_cuda_reports():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gan_inpainting_torch.infer.inpaint import Inpainter
    from gan_inpainting_torch.models.generator import build_generator
    from gan_inpainting_torch.train.state import create_state
    from gan_inpainting_torch.train.step import make_train_step

    def where(found):
        return [f"{w.filename}:{w.lineno} {w.message}" for w in found]

    # one batch build and train step of places512_deepfill, shrunk
    cfg = apply_overrides(get_config("places512_deepfill"), [
        "data.image_size=128", "data.batch_size=2"])
    state = create_state(cfg, device="cuda")
    step = make_train_step(cfg)
    pool = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8,
                         device="cuda")

    def train_once(i):
        batch = make_train_batch(pool, torch.Generator().manual_seed(i),
                                 cfg.mask, flip=cfg.data.random_flip)
        step(state, batch)

    for i in range(2):                       # builds, cuDNN's search, R1
        train_once(i)
    n_train, found_train = _syncs(lambda: train_once(2))

    # one inpaint_batch
    scfg = apply_overrides(get_config("serve_v4_8"), [
        "infer.batch_buckets=8", "infer.size_buckets=128"])
    gen = build_generator(scfg.model, device="cuda", seed=3)
    inp = Inpainter(scfg, gen.state_dict(), device="cuda")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (8, 128, 128, 3), dtype=np.uint8)
    msk = (rng.random((8, 128, 128)) < 0.3).astype(np.float32)
    for _ in range(2):
        inp.inpaint_batch(img, msk)
    n_serve, found_serve = _syncs(lambda: inp.inpaint_batch(img, msk))
    inp.close()
    print(f"host syncs: train batch + step {n_train} "
          f"{where(found_train)}; inpaint_batch {n_serve} "
          f"{where(found_serve)}")
    assert n_train == len(found_train) > 0, where(found_train)
    assert n_serve == len(found_serve) == 3, where(found_serve)
    assert all(w.filename.endswith("spans.py")
               for w in found_train + found_serve)
