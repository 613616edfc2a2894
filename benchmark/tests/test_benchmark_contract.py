"""The benchmark's files against its contract: names, units, the links
between BENCHMARK.json, the cells, the mixes, the configurations and the
metrics; the generators' determinism; the counts against the kernel
table's bounds; the modules a run loads. CPU only:

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import ast
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.harness import count, inputs, spec, trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
PER_LAYER = {m["name"]: m for m in BENCH["per_layer"]}
CELLS = [w["name"] for w in BENCH["workloads"]]
FORBIDDEN = {"jax", "jaxlib", "flax", "gan_inpainting_tpu"}


def test_names_and_units_use_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + list(E2E) + list(PER_LAYER)
             + [w["traffic"] for w in BENCH["workloads"]])
    for c in BENCH["configs"]:
        names += c["reduced"]
    for n in names:
        assert spec.NAME_RE.match(n), n
    for m in [*E2E.values(), *PER_LAYER.values()]:
        assert spec.UNIT_RE.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for name in CELLS:
        cell = spec.workload(name)
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert spec.NAME_RE.match(m)
            assert spec.UNIT_RE.match(spec.metric(m).UNIT)


def test_one_line_fields_and_sizes():
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in PER_LAYER.values()]
                 + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51


def test_cells_link_to_files_that_exist():
    for w in BENCH["workloads"]:
        cell = spec.workload(w["name"])
        for key in ("config", "traffic", "chips", "why"):
            assert cell[key] == w[key], (w["name"], key)
        spec.config(cell["config"])
        assert spec.cell_params(cell)["driver"]
        for m in cell["end_to_end"]:
            assert m in E2E
        for m in cell["per_layer"]:
            assert m in PER_LAYER
        assert cell["limits"]
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_metric_files_match_benchmark_json():
    for name, m in {**E2E, **PER_LAYER}.items():
        mod = spec.metric(name)
        assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (
            m["unit"], m["better"], m["source"]), name
        if name in PER_LAYER:
            assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])


def test_cell_lists_of_metrics_agree():
    for name, m in {**E2E, **PER_LAYER}.items():
        cells = m.get("workloads", CELLS)
        for c in CELLS:
            cell = spec.workload(c)
            listed = name in cell["end_to_end"] + cell["per_layer"]
            assert listed == (c in cells), (name, c)


def test_every_per_layer_metric_moves_what_its_cells_report():
    for name, m in PER_LAYER.items():
        assert m["moves"] in E2E
        for c in m["workloads"]:
            assert m["moves"] in spec.workload(c)["end_to_end"], (name, c)


def test_every_cell_reports_setup_and_another_end_to_end_metric():
    for c in CELLS:
        cell = spec.workload(c)
        assert "setup_s" in cell["end_to_end"]
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]


def test_a_new_cell_is_taken_from_its_file_alone(tmp_path, monkeypatch):
    """A fresh workload file (and its BENCHMARK.json entry) runs without
    an edit to any file the benchmark has."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = spec.workload("serve256_batch64")
    fresh = dict(base, why="a fresh cell for the test")
    bench["workloads"].append({"name": "fresh_cell", "config": base["config"],
                               "traffic": base["traffic"], "chips": 1,
                               "why": fresh["why"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark" / "workloads" / "fresh_cell.json").write_text(
        json.dumps(fresh))
    monkeypatch.setattr(spec, "BENCH_DIR", root / "benchmark")
    monkeypatch.setattr(spec, "ROOT", root)
    from benchmark import run

    result = run.run_cell(
        "fresh_cell", 3, 0.2, False, torch.device("cpu"),
        ["model.base_features=8", "infer.size_buckets=32",
         "infer.batch_buckets=1,4", "model.dtype_policy=f32"],
        {"size": 32, "batch": 4, "pool_batches": 2, "ref_block": 4,
         "warm_calls": 1})
    assert result["correct"] and result["metrics"]["serve_img_per_s"]


def test_generators_repeat_for_a_seed_and_differ_across_seeds():
    big = 2 ** 31 + 12345
    m = {"max_strokes": 8, "max_segments": 8, "min_width": 6.0,
         "max_width": 24.0, "max_step": 40.0}
    for fn in (lambda s: inputs.images_u8(3, 32, s, "cpu", "t"),
               lambda s: inputs.masks(3, 32, m, s, "cpu", "t"),
               lambda s: inputs.generator_params(8, s, "cpu")[
                   "coarse.conv0.weight"]):
        x, y, z = fn(big), fn(big), fn(big + 1)
        assert torch.equal(x, y) and not torch.equal(x, z)


def test_counts_give_the_kernel_tables_bounds():
    """Rows 1 (B 8, 256² map) and 2 (B 2, 512²) of the kernel table: all
    pairs 0.0814 / 0.3257 ms; the valid-pair bounds 0.0596 / 0.3053 ms at
    the valid-key shares those runs had. Row 5b at 8x512² 0.2745 ms (bytes);
    rows 4 and 5 in the ratio of their units (34 : 25)."""
    ms = lambda flops: flops / count.PEAK_BF16_FLOPS * 1e3  # noqa: E731
    for size, b, allp, valid in ((256, 8, 0.0814, 0.0596),
                                 (512, 2, 0.3257, 0.3053)):
        cells = count.attention_cells(size)
        got = ms(count.attention_fwd_flops(size, 192, b * cells))
        assert abs(got - allp) < 5e-5
        share = valid / allp
        got = ms(count.attention_fwd_flops(size, 192, b * cells * share))
        assert abs(got - valid) < 5e-5
    cells = count.attention_cells(512)
    fold = count.attention_bwd_bound_s(512, 192, 8, 0) * 1e3
    assert abs(fold - 0.2745) < 5e-4
    whole = count.attention_bwd_bound_s(512, 192, 8, 8 * cells) * 1e3 - fold
    pairs = 2.0 * cells * 8 * cells * 192
    assert abs(whole - ms(pairs * (34 + 25))) < 1e-9


def test_model_flops_of_a_256_image():
    """205.07 GFLOP of convs plus 10.07 of attention over all pairs: the
    215.14 GFLOP per 256² image of the unfused generator."""
    conv = count.generator_conv_flops(48, 256)
    total = conv + count.attention_fwd_flops(256, 192,
                                             count.attention_cells(256))
    assert abs(total / 1e9 - 215.14) < 0.01


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in FORBIDDEN | {"gan_inpainting_torch"}, (
                    path.name, n)


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_reference_loads_no_program_module():
    code = ("import sys; import benchmark.reference.deepfill, "
            "benchmark.reference.train; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=_clean_env(), check=True)
    tops = set(ast.literal_eval(out.stdout.strip()))
    assert not tops & (FORBIDDEN | {"gan_inpainting_torch"})


def test_a_run_loads_no_jax():
    code = """
import sys, torch
from benchmark import run
r = run.run_cell("serve256_batch64", 1, 0.2, False, torch.device("cpu"),
    ["model.base_features=8", "infer.size_buckets=32",
     "infer.batch_buckets=1,4", "model.dtype_policy=f32"],
    {"size": 32, "batch": 4, "pool_batches": 2, "ref_block": 4,
     "warm_calls": 1})
assert r["correct"]
print(run.forbidden_modules(), "gan_inpainting_torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=_clean_env(), check=True)
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "gan_inpainting_tpu_x", sys)
    assert "gan_inpainting_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gan_inpainting_tpu.ops", sys)
    assert "gan_inpainting_tpu" in run.forbidden_modules()


def test_without_a_card_a_run_fails_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "serve256_batch64",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, env=_clean_env())
    assert out.returncode != 0 and out.stdout == ""


def test_bounds_and_run_length_fit_the_contract():
    for m in E2E.values():
        assert 0.01 <= m["bound"] <= 0.25
    n = 24
    total = ((2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 2 * 90
             + 1200)
    assert total <= 43200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, math.floor(0.25 * len(CELLS)))


class _Event:
    def __init__(self, name, start, end, cuda=True):
        self._n, self._s, self._d, self._cuda = name, start, end - start, cuda

    def name(self):
        return self._n

    def device_type(self):
        d = torch.autograd.DeviceType
        return d.CUDA if self._cuda else d.CPU

    def is_user_annotation(self):
        return False

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_trace_puts_host_spans_on_the_device_clock_by_the_marker():
    """The device's clock runs 1 ms ahead of the host's here: the fill
    kernel nearest the marker's launch (host 100 ns) gives the offset, the
    window and the spans move by it, an event from before the profile
    began is clipped, and each idle gap goes to the span open at its
    middle."""
    off, fill = 1_000_000, "vectorized_elementwise_kernel<4, FillFunctor<float>>"
    events = [_Event("k2", off + 5000, off + 8000),
              _Event("cudaLaunchKernel", 50, 90, cuda=False),
              _Event("stale", off - 600, off + 20),
              _Event(fill, off + 100, off + 101),
              _Event("k1", off + 1000, off + 3000)]
    prof = type("P", (), {})()
    prof.profiler = type("Q", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda self:
                                                  events})()
    s = trace.summarize(prof, 100, (1000, 11000),
                        [(1000, 5500, "a"), (5500, 11000, "b")])
    assert s["clock_offset_ns"] == off and s["marker_found"]
    assert s["busy_s"] == 5000 / 1e9 and s["window_s"] == 10000 / 1e9
    assert s["kernels_s"] == {"k1": 2000 / 1e9, "k2": 3000 / 1e9}
    assert s["idle_by_span_s"] == {"a": 2000 / 1e9, "b": 3000 / 1e9}


def test_configurations_run_their_published_generator_width():
    """cnum 48 in the v2 code: 24 ELU features and 24 gates per conv."""
    for c in BENCH["configs"]:
        cfg = spec.config(c["name"])
        assert (cfg["program_config"]["model"]["base_features"]
                == cfg["published"]["base_features"] == 24)
        shapes = __import__("benchmark.reference.deepfill", fromlist=["x"]) \
            .generator_shapes(24)
        assert sum(math.prod(s) for s, _ in shapes.values()) == \
            cfg["published"]["parameters" if "parameters" in cfg["published"]
                             else "parameters_g"]
        assert c["reduced"] == cfg["reduced"]
