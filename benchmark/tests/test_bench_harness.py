"""The harness: names, `BENCHMARK.json`'s shape, the no-JAX check, the result
line, and faults planted in the timed path coming out as not correct.

The runs here skip the look for a card (``--device cpu``: the small
geometry, the port's plain kernels) and drive the rest of a run."""

import json
import re
import time

import pytest
import torch

from harness import main as M

SPEC = M.load_json(M.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_by_name(cell):
    c = M.Cell(cell)
    assert c.mix["mode"] in ("infer", "train")
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    moves = {m["name"] for m in c.end_to_end}
    assert all(m["moves"] in moves for m in c.per_layer)
    for k in c.cfg["bench"]["limits"][c.mix["mode"]]:
        assert isinstance(k, str)


def test_unknown_names_fail():
    with pytest.raises(KeyError):
        M.Cell("no-such-cell")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"][0]["traffic"] = "no-such-mix"
    with pytest.raises(KeyError):
        M.Cell(spec["workloads"][0]["name"], spec=spec)
    spec = json.loads(json.dumps(SPEC))
    spec["per_layer"][0]["name"] = "no_such_metric"
    with pytest.raises(KeyError):
        M.Cell(spec["per_layer"][0]["workloads"][0], spec=spec)


def test_cell_on_several_chips_fails():
    # one process drives one card: a four-chip cell must not report one card's numbers
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"][0]["chips"] = 4
    with pytest.raises(KeyError, match="chips"):
        M.Cell(spec["workloads"][0]["name"], spec=spec)


def test_benchmark_json_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        assert c["file"].startswith(SPEC["paths"][0] + "/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert len(w["why"]) <= 200
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert set(m.get("workloads", [])) <= set(CELLS)


def test_no_jax_check_compares_whole_names():
    assert M.forbidden_modules(["vision3d_tpu.models.second", "numpy"]) == ["vision3d_tpu"]
    assert M.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) == ["flax", "jax", "jaxlib"]
    assert M.forbidden_modules(["vision3d_tpu_torch.models", "jaxtyping", "torch"]) == []


def _run(cell, seed, fault="none", control=False, f32=True, trace=0):
    c = M.Cell(cell, quick=True)
    if f32:
        c.cfg = {**c.cfg, "compute_dtype": "float32"}
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", "0.5", "--device", "cpu",
            "--fault", fault, "--trace", str(trace)] + (["--control"] if control else [])
    args = M.parse_args(argv)
    # oneDNN's float32 conv backward is a reduced-accuracy algorithm: off for
    # float32 comparisons, on for bfloat16 (without it bf16 runs crawl)
    with torch.backends.mkldnn.flags(enabled=not f32):
        res = M.run_once(c, seed, args, torch.device("cpu"), time.perf_counter())
    return c, args, res


def test_result_line_keys():
    c, args, res = _run("second-car-infer-b8", 2**31 + 1)
    line = M.result_line(c, res, args, torch.device("cpu"))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["metrics"] == {}            # no device metric from a CPU run
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())


@pytest.mark.parametrize("cell,fault", [("second-car-infer-b8", "alter"),
                                        ("second-car-infer-b8", "half_batch"),
                                        ("second-car-train-b8", "half_batch"),
                                        ("second-car-train-b8", "unchanged"),
                                        ("second-car-train-b8", "dw_scale")])
def test_planted_fault_is_not_correct(cell, fault):
    c, _, res = _run(cell, 2**31 + 3, fault=fault)
    ok, checks = M.verdict(c, res)
    assert not ok, checks


@pytest.mark.cuda
def test_one_run_on_the_card(cuda_device):
    c = M.Cell("second-car-infer-b8")
    args = M.parse_args(["--workload", c.name, "--seed", "12345", "--seconds", "3"])
    res = M.run_once(c, 12345, args, cuda_device, time.perf_counter())
    line = M.result_line(c, res, args, cuda_device)
    assert line["correct"] and set(line["metrics"]) == {m["name"] for m in c.end_to_end}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
