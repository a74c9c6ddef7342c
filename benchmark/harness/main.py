"""One run of one cell: set-up, warm-up, the measured window, the check
against the plain reference, and one result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names its configuration (``configs/<config>.json``: the port's
``Config`` fields plus the benchmark's ``bench`` block) and its traffic
(``traffic/<traffic>.json``); each per-layer metric is a reader
``metrics/<name>.py``. Everything is found by the names in
``BENCHMARK.json``; an unknown name fails.

Options for setting limits, which a measured run never takes:
``--control`` puts the reference, in float8, in the program's place;
``--fault`` plants a fault in the timed path; ``--readings N`` runs N
seeds from ``--seed`` in one process and prints each one's numbers;
``--device cpu`` rehearses the whole run at a small geometry and prints
no device metric.
"""

import argparse
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from harness import compare, reference as ref, trace, traffic, weights

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "vision3d_tpu")
NOT_PROGRAM = ("bench", "assumed", "source")
# the CPU rehearsal's geometry and load (the port's bench --quick)
QUICK = dict(max_voxels=4096, voxel_size=[0.1, 0.1, 0.1],
             grid_bounds=[0.0, -19.2, -3.0, 38.4, 19.2, 1.0])
QUICK_MIX = dict(batch=2, points=3000, pool=3)
FAULTS = ("none", "alter", "half_batch", "unchanged", "dw_scale")
# the leaf whose gradient the ``dw_scale`` fault doubles: a stage-2 sparse
# conv, whose dW the program regathers with kernel B4
DW_FAULT_LEAF = "cnn.subm.4.weight"


def forbidden_modules(modules=None):
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's name only begins with the JAX package's)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic
    and metrics."""

    def __init__(self, name, spec=None, quick=False):
        spec = spec or load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
        self.name, self.entry = name, cells[name]
        if self.entry["chips"] != 1:
            # one process drives one card: a cell on several cards needs a
            # launcher of ranks and a reference over the global batch
            raise KeyError(f"workload {name!r} asks for {self.entry['chips']} chips; "
                           "the harness runs cells on one chip only")
        configs = {c["name"]: c for c in spec["configs"]}
        if self.entry["config"] not in configs:
            raise KeyError(f"workload {name!r} names unknown config {self.entry['config']!r}")
        self.cfg = load_json(ROOT / configs[self.entry["config"]]["file"])
        path = BENCH / "traffic" / f"{self.entry['traffic']}.json"
        if not path.is_file():
            raise KeyError(f"workload {name!r} names traffic {self.entry['traffic']!r}, "
                           f"but {path.relative_to(ROOT)} does not exist")
        self.mix = load_json(path)
        if quick:
            self.cfg = {**self.cfg, **QUICK}
            self.mix = {**self.mix, **QUICK_MIX}
        self.end_to_end = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
        moves = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m["workloads"] or ("workloads" not in m and m["moves"] in moves)]
        self.readers = {m["name"]: load_reader(m["name"]) for m in self.per_layer}

    def program_config(self):
        from vision3d_tpu_torch.config import Config
        return Config().merge({k: v for k, v in self.cfg.items() if k not in NOT_PROGRAM})


def load_reader(name):
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"per-layer metric {name!r} has no reader {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for attr in ("SUBMODULES", "KERNELS", "read"):
        if not hasattr(mod, attr):
            raise AttributeError(f"metric reader {path.name} lacks {attr}")
    return mod


def to_device(batch: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=30).stdout
        return out.strip().splitlines()[0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


class TracedStretch:
    """The profiler over ``units`` whole batches or steps of the window,
    from the ``start``-th on."""

    def __init__(self, start, units, dev):
        self.start, self.units, self.dev = start, units, dev
        self.prof, self.t0, self.wall_s, self.done, self.indices = None, None, None, 0, []

    def before(self, n, i):
        if n == self.start:
            sync(self.dev)
            self.prof = trace.profiler()
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        if self.prof is not None and self.wall_s is None:
            self.indices.append(i)

    def after(self, n):
        if self.prof is not None and self.wall_s is None and n == self.start + self.units - 1:
            sync(self.dev)
            self.wall_s = time.perf_counter() - self.t0
            self.prof.__exit__(None, None, None)
            self.done = self.units


# ---------------------------------------------------------------- inference

def build_inference(cell, pcfg, sd, dev):
    kind = cell.cfg["bench"]["model"]
    with torch.device(dev):
        if kind == "second":
            from vision3d_tpu_torch.models.second import Second
            model = Second(pcfg)
        elif kind == "pvrcnn2":
            from vision3d_tpu_torch.models.pvrcnn import PV_RCNN
            model = PV_RCNN(pcfg, two_stage=True)
        else:
            raise KeyError(f"unknown model {kind!r} in config of {cell.name!r}")
    model.load_state_dict(sd, strict=True)
    return model.eval()


def control_outputs(cell, sd, batch, anchors, u):
    """The reference in float8 in the program's place: the same outputs
    the program's timed path gives."""
    cfg = cell.cfg
    with weights.no_tf32(), torch.no_grad():
        ctx = ref.Ctx("eval", quant=True)
        pv = cfg["bench"]["model"] == "pvrcnn2"
        x, cls, reg, scales = ref.second_maps(ctx, sd, cfg, batch["points"], batch["num_points"],
                                              need_scales=pv)
        scores, idx = compare.program_choice(cls, cfg["proposal"]["topk"])
        boxes = compare.decoded_at(reg, anchors, idx)
        out = dict(cls=cls, reg=reg)
        if pv:
            kp, pf, _ = ref.point_branch(ctx, sd, cfg, batch["points"], batch["num_points"],
                                         x, scales)
            out.update(keypoints=kp, point_features=pf, proposals=boxes)
            boxes, conf_logit, deltas = ref.stage2(ctx, sd, cfg, boxes, kp, pf, u)
            out["refine"] = (deltas, conf_logit)
            scores = torch.sigmoid(conf_logit) * scores
        keep = ref.nms_keep(boxes, scores, cfg["proposal"]["nms_iou_threshold"],
                            cfg["iou_angle_mode"])
        valid = keep & (scores > cfg["anchors"][0]["score_thresh"])
        out["det"] = (boxes, scores, torch.zeros_like(idx, dtype=torch.int32), valid)
    return out


def run_infer(cell, seed, seconds, tracing, fault, control, dev, t_start):
    cfg, mix = cell.cfg, cell.mix
    pv = cfg["bench"]["model"] == "pvrcnn2"
    anchors = torch.as_tensor(ref.make_anchors(cfg), device=dev)
    b, p = mix["batch"], mix["pool"]
    draws = [torch.from_numpy(traffic.grid_draws(seed, i, b, cfg["proposal"]["topk"],
                                                 cfg["gridpool"]["num_gridpoints"])).to(dev)
             if pv else None for i in range(p + 1)]
    sd = weights.draw(cfg, seed, dev)
    calib = to_device(traffic.make_batch(mix, seed, traffic.CALIBRATION, 0), dev)
    weights.calibrate(cfg, sd, calib, anchors, draws[p])
    del calib
    pool = [to_device(traffic.make_batch(mix, seed, traffic.POOL, i), dev) for i in range(p)]
    if dev.type == "cuda":
        sync(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    outputs, cur, hooks, model = {}, {}, [], None
    if not control:
        model = build_inference(cell, cell.program_config(), sd, dev)
        hooks.append(model.head.register_forward_hook(
            lambda _m, _a, o: cur.update(cls=o[0], reg=o[1])))
        if pv:
            hooks.append(model.keypoint_seg.register_forward_pre_hook(
                lambda _m, a: cur.update(point_features=a[0])))
            hooks.append(model.roi_grid_pool.register_forward_pre_hook(
                lambda _m, a: cur.update(proposals=a[0], keypoints=a[1])))
            hooks.append(model.refinement.register_forward_hook(
                lambda _m, _a, o: cur.update(refine=o)))

    def program(batch, u):
        if pv:
            det, _ = model.inference_two_stage(batch["points"], batch["num_points"], anchors, u=u)
        else:
            det, _ = model.inference(batch["points"], batch["num_points"], anchors)
        return dict(cur, det=tuple(det))

    def forward(i):
        cur.clear()
        batch, u = pool[i], draws[i]
        if control:
            out = control_outputs(cell, sd, batch, anchors, u)
        elif fault == "half_batch":
            h = b // 2
            half = program({k: v[:h] for k, v in batch.items()}, None if u is None else u[:h])
            out = {k: (tuple(torch.cat([t, t]) for t in v) if isinstance(v, tuple)
                       else torch.cat([v, v])) for k, v in half.items()}
        else:
            out = program(batch, u)
        if fault == "alter":
            boxes = out["det"][0].clone()
            boxes[0, 0, 0] += 0.5
            out["det"] = (boxes,) + out["det"][1:]
        outputs[i] = out
        return out["det"]

    spans = None
    if tracing and model is not None:
        spans = trace.Spans(model, sorted({s for r in cell.readers.values() for s in r.SUBMODULES}))
    with torch.no_grad():
        for i in range(min(mix["warmup"], p)):
            forward(i)
        sync(dev)
        setup_s = time.perf_counter() - t_start
        found = forbidden_modules()
        lat, attempted, failed = [], 0, 0
        stretch = TracedStretch(**cfg["bench"]["trace"][mix["mode"]], dev=dev) if tracing else None
        t0 = time.perf_counter()
        n = 0
        while True:
            enqueued = time.perf_counter()
            if (enqueued - t0 >= seconds
                    and (stretch is None or stretch.done or n < stretch.start)):
                break
            i = n % p
            if stretch:
                stretch.before(n, i)
            try:
                det = [t.cpu() for t in forward(i)]
                ok = all(torch.isfinite(t.float()).all() for t in det[:2])
            except (RuntimeError, ValueError):
                traceback.print_exc()
                ok = False
            lat.append(time.perf_counter() - enqueued)
            attempted += 1
            failed += not ok
            if stretch:
                stretch.after(n)
            n += 1
        window_s = time.perf_counter() - t0
    if spans:
        spans.remove()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    found = sorted(set(found) | set(forbidden_modules()))
    for h in hooks:
        h.remove()
    del model, hooks
    rng = traffic.rng_for(seed, traffic.CHECK)
    sample = [int(i) for i in rng.permutation(p) if int(i) in outputs][:cfg["bench"]["check_batches"]]
    for i in list(outputs):
        if i not in sample:
            del outputs[i]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = {}
    for i in sample:
        if pv:
            got = compare.judge_pvrcnn(cfg, outputs[i], pool[i], sd, anchors, draws[i])
        else:
            got = compare.judge_second(cfg, outputs[i], pool[i], sd, anchors)
        for k, v in got.items():
            numbers[k] = max(numbers.get(k, v), v)
    frames = b * (attempted - failed)
    metrics = dict(infer_frames_per_s=(frames / window_s, "frames/s"),
                   infer_batch_ms_p95=(1e3 * statistics.quantiles(lat, n=20)[-1]
                                       if len(lat) >= 2 else float("nan"), "ms"),
                   setup_s=(setup_s, "s"),
                   peak_mem_gib=(peak / 2**30, "GiB"))
    run = None
    if stretch is not None and stretch.prof is not None:
        run = traced_run(cell, stretch, pool, draws if pv else None, sd, anchors)
    return dict(attempted=attempted, failed=failed, metrics=metrics, numbers=numbers,
                peak=peak, forbidden=found, run=run, window_s=window_s)


# ----------------------------------------------------------------- training

def trainable(cfg):
    return [k for k in weights.param_shapes(cfg)
            if not k.endswith((".running_mean", ".running_var", ".num_batches_tracked"))]


def reference_train(cfg, sd, batches, anchors, quant=False):
    """The reference's first steps from the same weights: (loss of each
    step, the first gradient's norm per leaf as Adam gets it, after the
    clip, the change of each leaf after the steps, the first step's head
    maps, its counts)."""
    names = trainable(cfg)
    params = {k: sd[k].clone().requires_grad_(True) for k in names}
    bufs = {k: v for k, v in sd.items() if k not in params}
    opt = torch.optim.Adam(list(params.values()), lr=ref.lr_at(cfg, 0), betas=(0.9, 0.999),
                           eps=1e-8)
    losses, first, maps, step_counts = [], None, None, None
    with weights.no_tf32():
        for i, batch in enumerate(batches):
            opt.zero_grad(set_to_none=True)
            with torch.no_grad():
                targets = ref.assign_targets(batch["boxes"], batch["gt_mask"], anchors, cfg)
            ctx = ref.Ctx("train", quant)
            _, cls, reg, _ = ref.second_maps(ctx, {**bufs, **params}, cfg, batch["points"],
                                             batch["num_points"])
            loss = ref.proposal_loss(cls, reg, targets, cfg["train"]["lam"])["loss"]
            loss.backward()
            grads = [p.grad for p in params.values() if p.grad is not None]
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            if norm >= cfg["train"]["grad_clip_norm"]:
                torch._foreach_mul_(grads, cfg["train"]["grad_clip_norm"] / norm)
            if i == 0:
                first = {k: float(p.grad.norm()) if p.grad is not None else 0.0
                         for k, p in params.items()}
                step_counts = ctx.counts
                maps = dict(cls=cls.detach(), reg=reg.detach())
            for group in opt.param_groups:
                group["lr"] = ref.lr_at(cfg, i)
            opt.step()
            losses.append(float(loss.detach()))
            del cls, reg, loss
    change = {k: float((params[k].detach() - sd[k]).norm()) for k in names}
    return losses, first, change, maps, step_counts


def train_numbers(cfg, got, want):
    losses_p, first_p, change_p, maps_p = got
    losses_r, first_r, change_r, maps_r, _ = want
    n = min(len(maps_p["cls"]), len(maps_r["cls"]))    # a half batch compares its half
    med = float(np.median([first_r[k] for k in first_r]))
    counted = [k for k in first_r if first_r[k] >= 1e-3 * med]
    shapes = weights.param_shapes(cfg)
    grad = compare.leaf_gaps(first_p, first_r, counted)
    step = compare.leaf_gaps(change_p, change_r, counted)
    return dict(loss_gap=max(abs(a - b) / abs(b) for a, b in zip(losses_p, losses_r)),
                grad_gap=max(grad.values()),
                grad_gap_weights=max(v for k, v in grad.items() if len(shapes[k][0]) >= 2),
                step_gap=max(step.values()),
                loss_gap_first=abs(losses_p[0] - losses_r[0]) / abs(losses_r[0]),
                cls_gap_first=compare.rel_gap(maps_p["cls"][:n], maps_r["cls"][:n]),
                reg_gap_first=compare.rel_gap(maps_p["reg"][:n], maps_r["reg"][:n]),
                grad_gap_median=float(np.median(list(grad.values()))),
                step_gap_median=float(np.median(list(step.values()))),
                leaves_counted=len(counted))


def run_train(cell, seed, seconds, tracing, fault, control, dev, t_start):
    cfg, mix = cell.cfg, cell.mix
    anchors = torch.as_tensor(ref.make_anchors(cfg), device=dev)
    b, p = mix["batch"], mix["pool"]
    wlh = cfg["anchors"][0]["wlh"]
    sd = weights.draw(cfg, seed, dev)
    pool = [to_device(traffic.make_batch(mix, seed, traffic.POOL, i, wlh), dev) for i in range(p)]
    checked = cfg["bench"]["check_steps"]
    if dev.type == "cuda":
        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    attempted = failed = 0
    window_s, stretch, found = 0.0, None, forbidden_modules()
    if control:
        got = reference_train(cfg, sd, pool[:checked], anchors, quant=True)[:4]
        setup_s = time.perf_counter() - t_start
        metrics = {}
    else:
        from vision3d_tpu_torch.training.train import create_train_state, make_train_step
        pcfg = cell.program_config()
        model, tx, state = create_train_state(
            pcfg, steps_per_epoch=cfg["bench"]["steps_per_epoch"], device=dev, state_dict=sd)
        step_fn = make_train_step(model, tx, pcfg, anchors=anchors)
        named = dict(model.named_parameters())
        start = {k: v.detach().clone() for k, v in named.items()}
        if fault == "dw_scale":
            named[DW_FAULT_LEAF].register_hook(lambda g: 2 * g)

        def step(i):
            batch = pool[i]
            if fault == "half_batch":
                batch = {k: v[:b // 2] for k, v in batch.items()}
            if fault == "unchanged":
                saved = ({k: v.clone() for k, v in model.state_dict().items()}, state.step)
            _, losses = step_fn(state, batch)
            if fault == "unchanged":
                model.load_state_dict(saved[0])
                tx.adam.state.clear()
                state.step = saved[1]
            return losses["loss"]

        losses, maps = [], {}
        hook = model.head.register_forward_hook(
            lambda _m, _a, o: maps.update(cls=o[0].detach().clone(), reg=o[1].detach().clone()))
        for i in range(checked):
            losses.append(float(step(i)))
            if i == 0:
                hook.remove()
                first = {k: float(tx.adam.state[v]["exp_avg"].norm()) / 0.1
                         if v in tx.adam.state else 0.0 for k, v in named.items()}
        change = {k: float((v.detach() - start[k]).norm()) for k, v in named.items()}
        got = (losses, first, change, maps)
        del start
        spans = None
        if tracing:
            spans = trace.Spans(model, sorted({s for r in cell.readers.values()
                                               for s in r.SUBMODULES}))
        sync(dev)
        setup_s = time.perf_counter() - t_start
        found = forbidden_modules()
        stretch = TracedStretch(**cfg["bench"]["trace"][mix["mode"]], dev=dev) if tracing else None
        pending = None
        t0 = time.perf_counter()
        n = 0
        while True:
            if (time.perf_counter() - t0 >= seconds
                    and (stretch is None or stretch.done or n < stretch.start)):
                break
            i = (checked + n) % p
            if stretch:
                stretch.before(n, i)
            try:
                loss = step(i)
            except (RuntimeError, ValueError):
                traceback.print_exc()
                loss = torch.tensor(float("nan"))
            if pending is not None:            # read the last step's loss one step late
                failed += not math.isfinite(float(pending))
            pending = loss
            attempted += 1
            if stretch:
                stretch.after(n)
            n += 1
        if pending is not None:
            failed += not math.isfinite(float(pending))
        window_s = time.perf_counter() - t0
        if spans:
            spans.remove()
        del model, tx, state, step_fn, named
        metrics = dict(train_frames_per_s=(b * (attempted - failed) / window_s, "frames/s"))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    found = sorted(set(found) | set(forbidden_modules()))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_train(cfg, sd, pool[:checked], anchors)
    metrics.update(setup_s=(setup_s, "s"), peak_mem_gib=(peak / 2**30, "GiB"))
    run = None
    if stretch is not None and stretch.prof is not None:
        run = traced_run(cell, stretch, pool, None, sd, anchors)
    return dict(attempted=attempted, failed=failed, metrics=metrics,
                numbers=train_numbers(cfg, got, want), peak=peak, forbidden=found, run=run,
                window_s=window_s)


# -------------------------------------------------------------- the trace

class TracedRun:
    """What a metric reader reads: the trace, the reference's counts of the
    work of each traced batch or step, their number and the stretch's wall
    time."""

    def __init__(self, tr, unit_counts, units, wall_s, cfg):
        self.trace, self.unit_counts, self.units, self.wall_s = tr, unit_counts, units, wall_s
        self.cfg = cfg


@torch.no_grad()
def traced_run(cell, stretch, pool, draws, sd, anchors):
    tr = trace.Trace(stretch.prof)
    cfg = cell.cfg
    per_index = {}
    with weights.no_tf32():
        for i in dict.fromkeys(stretch.indices):
            ctx = ref.Ctx("eval")
            batch = pool[i]
            x, cls, reg, scales = ref.second_maps(ctx, sd, cfg, batch["points"],
                                                  batch["num_points"],
                                                  need_scales=draws is not None)
            if draws is not None:
                kp, pf, _ = ref.point_branch(ctx, sd, cfg, batch["points"], batch["num_points"],
                                             x, scales)
                boxes, logits = ref.decode_all(cls, reg, anchors)
                _, idx = ref.topk_stable(logits, cfg["proposal"]["topk"])
                proposals = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 7))
                ref.stage2(ctx, sd, cfg, proposals, kp, pf, draws[i])
            per_index[i] = ctx.counts
    return TracedRun(tr, [per_index[i] for i in stretch.indices], stretch.units,
                     stretch.wall_s, cfg)


# ------------------------------------------------------------------- main

def parse_args(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default="none", choices=FAULTS)
    ap.add_argument("--readings", type=int, default=0)
    return ap.parse_args(argv)


def run_once(cell, seed, args, dev, t_start):
    runner = {"infer": run_infer, "train": run_train}.get(cell.mix["mode"])
    if runner is None:
        raise KeyError(f"unknown traffic mode {cell.mix['mode']!r}")
    return runner(cell, seed, args.seconds, bool(args.trace), args.fault, args.control, dev,
                  t_start)


def verdict(cell, res):
    limits = cell.cfg["bench"]["limits"][cell.mix["mode"]]
    checks = {k: {"value": res["numbers"][k], "limit": lim} for k, lim in limits.items()}
    missing = [k for k in limits if k not in res["numbers"]]
    ok = (not missing and res["attempted"] > 0 and res["failed"] == 0
          and all(c["value"] <= c["limit"] for c in checks.values()))
    return ok, checks


def result_line(cell, res, args, dev):
    ok, checks = verdict(cell, res)
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(res["peak"])}
    if dev.type == "cuda":
        device["power_limit"] = power_limit()
    line = {"correct": ok, "attempted": res["attempted"], "failed": res["failed"]}
    metrics = {}
    if dev.type == "cuda" and not args.trace:
        names = {m["name"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": u} for k, (v, u) in res["metrics"].items()
                   if k in names}
    run = res["run"]
    if args.trace and dev.type == "cuda" and run is not None:
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device["busy_s"] = run.trace.busy_us() * 1e-6
        device["window_s"] = run.wall_s
        line["breakdown"] = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.idle_gaps()}
    line["metrics"] = metrics
    line["device"] = device
    line["checks"] = checks
    return line


def main(argv, t_start):
    args = parse_args(argv)
    dev = torch.device(args.device)
    cell = Cell(args.workload, quick=dev.type == "cpu")
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
            print(f"{args.workload}: needs {cell.entry['chips']} CUDA device(s), found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        torch.cuda.set_device(dev if dev.index is not None else 0)
        dev = torch.device("cuda", torch.cuda.current_device())
    if args.readings:
        for k in range(args.readings):
            seed = args.seed + k
            res = run_once(cell, seed, args, dev, time.perf_counter())
            ok, checks = verdict(cell, res)
            print(json.dumps({"seed": seed, "correct": ok, "numbers": res["numbers"],
                              "attempted": res["attempted"], "failed": res["failed"]}),
                  flush=True)
            del res
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        return 0
    res = run_once(cell, args.seed, args, dev, t_start)
    if res["forbidden"]:
        print(f"modules of JAX or the JAX package loaded: {', '.join(res['forbidden'])}",
              file=sys.stderr)
        return 3
    line = result_line(cell, res, args, dev)
    for k, c in line["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"check failed = {res['failed']} of {res['attempted']} (limit 0)", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
