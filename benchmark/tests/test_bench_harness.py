"""The harness: names, `BENCHMARK.json`'s shape, the no-JAX check, the result
line, model files found by name, the numbers recorded before the model
code moved into them, a cell on several cards as gloo ranks, and faults
planted in the timed path coming out as not correct.

The runs here skip the look for a card (``--device cpu``: the small
geometry, the port's plain kernels) and drive the rest of a run."""

import json
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from harness import files
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
    # only a training cell runs on several cards: an inference cell that asks
    # for four must not report one card's numbers
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"][0]["chips"] = 4
    with pytest.raises(KeyError, match="chips"):
        M.Cell(spec["workloads"][0]["name"], spec=spec)
    four = [w["name"] for w in SPEC["workloads"] if w["chips"] == 4]
    assert four and M.Cell(four[0]).chips == 4
    assert M.Cell(four[0], quick=True).chips == M.QUICK_CHIPS


def test_unknown_model_fails_and_names_the_model_files(tmp_path):
    spec = json.loads(json.dumps(SPEC))
    name = spec["workloads"][0]["name"]
    cfg = M.Cell(name).cfg
    with pytest.raises(KeyError, match=r"benchmark/models/ holds .*second\.py"):
        files.model("no-such-model")
    cfg["bench"]["model"] = "no-such-model"
    spec["configs"] = [dict(c, file=_write(cfg, tmp_path / "cfg.json")) for c in spec["configs"]]
    with pytest.raises(KeyError, match="no-such-model"):
        M.Cell(name, spec=spec)


def _write(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f)
    return str(path)


def test_a_model_is_a_file(tmp_path):
    """A model the harness has never seen, as a file in a models directory
    of its own, runs the CPU rehearsal; the harness's files stay as they
    are."""
    before = {p: p.read_bytes() for p in sorted((M.BENCH / "harness").glob("*.py"))}
    models = tmp_path / "models"
    models.mkdir()
    shutil.copy(files.MODELS / "second.py", models / "throwaway.py")
    cell = "second-car-infer-b8"
    spec = json.loads(json.dumps(SPEC))
    cfg = M.Cell(cell).cfg
    cfg["bench"]["model"] = "throwaway"
    conf = {c["name"]: c for c in spec["configs"]}[spec["workloads"][0]["config"]]
    conf["file"] = _write(cfg, tmp_path / "throwaway.json")
    c = M.Cell(cell, spec=spec, quick=True, models=models)
    assert c.model.__file__ == str(models / "throwaway.py")
    c.cfg = {**c.cfg, "compute_dtype": "float32"}
    args = M.parse_args(["--workload", cell, "--seed", "31", "--seconds", "0.5",
                         "--device", "cpu"])
    with torch.backends.mkldnn.flags(enabled=False):
        res = M.run_once(c, 31, args, torch.device("cpu"), time.perf_counter())
    assert M.verdict(c, res)[0], res["numbers"]
    assert before == {p: p.read_bytes() for p in sorted((M.BENCH / "harness").glob("*.py"))}


RECORDED = M.load_json(M.BENCH / "tests" / "rehearsal_numbers.json")


@pytest.mark.parametrize("cell", sorted(RECORDED["numbers"]))
def test_rehearsal_numbers_equal_recorded(cell):
    """The numbers of each cell's CPU rehearsal equal, to the last bit, those
    the harness gave before its model code moved into model files."""
    c = M.Cell(cell, quick=True)
    c.cfg = {**c.cfg, "compute_dtype": RECORDED["compute_dtype"]}
    seed = RECORDED["seed"]
    args = M.parse_args(["--workload", cell, "--seed", str(seed), "--seconds",
                         str(RECORDED["seconds"]), "--device", "cpu"])
    with torch.backends.mkldnn.flags(enabled=False):
        res = M.run_once(c, seed, args, torch.device("cpu"), time.perf_counter())
    assert res["numbers"] == RECORDED["numbers"][cell]


def test_over_ranks_takes_rank0_or_the_largest():
    class Reader:
        OVER_RANKS = "max"

    c = M.Cell("second-car-train-b8x4")
    c.readers = {"a": object(), "b": Reader()}
    parts = [dict(peak=p, forbidden=f, failed=n,
                  trace=dict(readings=dict(a=a, b=b), busy_s=busy, window_s=w, breakdown=w))
             for p, f, n, a, b, busy, w in [(5, [], 0, 1.0, 2.0, 0.4, 1.0),
                                            (7, ["jax"], 1, 3.0, None, 0.6, 2.0),
                                            (6, [], 0, 2.0, 4.0, 0.5, 3.0)]]
    out = M.over_ranks(c, parts)
    assert out["peak"] == 7 and out["forbidden"] == ["jax"] and out["failed"] == 1
    assert out["trace"]["readings"] == dict(a=1.0, b=4.0)
    assert out["trace"]["busy_s"] == pytest.approx(0.5)
    assert out["trace"]["window_s"] == 1.0 and out["trace"]["breakdown"] == 1.0


def _ranks_run(cell, seed, fault):
    """A whole run of a cell on several cards as gloo ranks, from the root
    of the checkout, each rank on two threads: the result line."""
    import os

    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(seed), "--seconds", "1", "--device", "cpu", "--fault", fault],
                         cwd=M.ROOT, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _rank_run_f32(rank, world, port, cell, seed, fault, out):
    """One gloo rank of ``run_once`` in float32 (as ``_run``); rank 0 saves
    its verdict and numbers to ``out``."""
    import torch.distributed as dist

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        c = M.Cell(cell, quick=True)
        c.cfg = {**c.cfg, "compute_dtype": "float32"}
        args = M.parse_args(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                             "--device", "cpu", "--fault", fault])
        with torch.backends.mkldnn.flags(enabled=False):
            res = M.run_once(c, seed, args, torch.device("cpu"), time.perf_counter(),
                             M.Ranks(rank, world, dist.group.WORLD))
        if rank == 0:
            ok, checks = M.verdict(c, res)
            torch.save(dict(ok=ok, checks=checks, count=res["count"],
                            attempted=res["attempted"]), out)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("fault", ["none", "skip_allreduce", "half_batch", "unchanged"])
def test_ranks_rehearse_the_four_card_cell(fault, tmp_path):
    """Two gloo ranks at the small geometry. Through ``run.py`` (bfloat16,
    as on the card): rank 1 keeping its own gradient fails the ranks'
    agreement. In float32, where the small geometry's rounding cannot
    reach the limits: the ranks' parameters agree to the bit and the
    global reference's gaps stay under the limits, and half of each rank's
    batch left out or a step that leaves the state unchanged fail."""
    cell = next(w["name"] for w in SPEC["workloads"] if w["chips"] > 1)
    seed = 2**31 + 41
    if fault == "skip_allreduce":
        line = _ranks_run(cell, seed, fault)
        assert line["device"]["count"] == M.QUICK_CHIPS and line["attempted"] > 0
        assert not line["correct"] and line["checks"]["rank_param_gap"]["value"] > 0.0, line
        return
    import torch.multiprocessing as mp
    from vision3d_tpu_torch.parallel.mesh import free_port

    out = tmp_path / "rank0.pt"
    mp.start_processes(_rank_run_f32, args=(M.QUICK_CHIPS, free_port(), cell, seed, fault,
                                            str(out)),
                       nprocs=M.QUICK_CHIPS, join=True, start_method="spawn")
    got = torch.load(out)
    assert got["count"] == M.QUICK_CHIPS and got["attempted"] > 0
    if fault == "none":
        assert got["ok"] and got["checks"]["rank_param_gap"]["value"] == 0.0, got
    else:
        assert not got["ok"], got


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
