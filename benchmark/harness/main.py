"""One run of one cell: set-up, warm-up, the measured window, the check
against the plain reference, and one result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names its configuration (``configs/<config>.json``: the port's
``Config`` fields plus the benchmark's ``bench`` block, whose ``model``
names a model file ``models/<model>.py``) and its traffic
(``traffic/<traffic>.json``); each per-layer metric is a reader
``metrics/<name>.py``. Everything is found by the names in
``BENCHMARK.json``; an unknown name fails.

A training cell may ask for several cards: one rank process a card, each
on its share of the global batch (``harness/traffic.py``), through the
port's several-rank training step. The process that prints the result
starts the ranks and prints what rank 0 gathered.

Options for setting limits, which a measured run never takes:
``--control`` puts the reference, in float8, in the program's place;
``--fault`` plants a fault in the timed path; ``--readings N`` runs N
seeds from ``--seed`` in one process and prints each one's numbers;
``--device cpu`` rehearses the whole run at a small geometry (a cell on
several cards on two gloo ranks) and prints no device metric.
"""

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

from harness import files, reference as ref, trace, traffic, weights

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "vision3d_tpu")
NOT_PROGRAM = ("bench", "assumed", "source")
# the CPU rehearsal's geometry and load (the port's bench --quick), and the
# most gloo ranks it starts for a cell on several cards
QUICK = dict(max_voxels=4096, voxel_size=[0.1, 0.1, 0.1],
             grid_bounds=[0.0, -19.2, -3.0, 38.4, 19.2, 1.0])
QUICK_MIX = dict(batch=2, points=3000, pool=3)
QUICK_CHIPS = 2
FAULTS = ("none", "alter", "half_batch", "unchanged", "dw_scale", "skip_allreduce")
# a collective that waits this long for a rank ends the run instead of
# hanging it
RANK_TIMEOUT = timedelta(seconds=300)


def forbidden_modules(modules=None):
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's name only begins with the JAX package's)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic,
    model file and metrics. ``chips`` is the number of ranks a run starts
    (on the CPU at most ``QUICK_CHIPS``)."""

    def __init__(self, name, spec=None, quick=False, models=files.MODELS):
        spec = spec or load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
        self.name, self.entry = name, cells[name]
        configs = {c["name"]: c for c in spec["configs"]}
        if self.entry["config"] not in configs:
            raise KeyError(f"workload {name!r} names unknown config {self.entry['config']!r}")
        self.cfg = load_json(ROOT / configs[self.entry["config"]]["file"])
        path = BENCH / "traffic" / f"{self.entry['traffic']}.json"
        if not path.is_file():
            raise KeyError(f"workload {name!r} names traffic {self.entry['traffic']!r}, "
                           f"but {path.relative_to(ROOT)} does not exist")
        self.mix = load_json(path)
        mode = self.mix["mode"]
        if mode not in ("infer", "train"):
            raise KeyError(f"unknown traffic mode {mode!r}")
        self.chips = self.entry["chips"]
        if self.chips != 1 and mode != "train":
            raise KeyError(f"workload {name!r} asks for {self.chips} chips; only a training "
                           "cell may run on several (one rank a card, a share of the batch each)")
        if quick:
            self.cfg = {**self.cfg, **QUICK}
            self.mix = {**self.mix, **QUICK_MIX}
            self.chips = min(self.chips, QUICK_CHIPS)
        self.model = files.model(self.cfg["bench"]["model"], mode, models)
        # the configuration's limits of the mode, and any the traffic adds
        self.limits = {**self.cfg["bench"]["limits"][mode], **self.mix.get("limits", {})}
        self.end_to_end = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
        moves = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m["workloads"] or ("workloads" not in m and m["moves"] in moves)]
        self.readers = {m["name"]: load_reader(m["name"]) for m in self.per_layer}

    def program_config(self):
        from vision3d_tpu_torch.config import Config
        return Config().merge({k: v for k, v in self.cfg.items() if k not in NOT_PROGRAM})


load_reader = files.reader


class Ranks:
    """This process's place among a cell's rank processes: ``rank``,
    ``world``, and ``host``, a gloo group for the harness's own exchanges
    of host values (the end of the window, each rank's readings), apart
    from the program's collectives."""

    def __init__(self, rank, world, host):
        self.rank, self.world, self.host = rank, world, host
        self.posted = None

    def gather(self, obj):
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.host)
        return out

    def rank0_said(self, flag: bool) -> bool:
        """Posts rank 0's ``flag`` without waiting for it, and returns the
        flag it posted at the last call (False at the first): every rank
        learns rank 0's word one step late, by which time it has long
        arrived, so no step waits on another rank for it."""
        word = torch.tensor([int(flag)], dtype=torch.int32)
        posted, self.posted = self.posted, (dist.broadcast(word, 0, group=self.host,
                                                           async_op=True), word)
        if posted is None:
            return False
        posted[0].wait()
        return bool(posted[1].item())

    def settle(self):
        """Waits for the word still in flight once the window has ended."""
        if self.posted is not None:
            self.posted[0].wait()
            self.posted = None


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


def seeded_draws(cell, seed, count, dev):
    """The model file's per-batch draws of pool batches 0..count-1, on the
    device (None where it draws nothing)."""
    out = []
    for i in range(count):
        d = cell.model.draws(seed, i, cell.mix["batch"], cell.cfg)
        out.append(None if d is None else torch.from_numpy(d).to(dev))
    return out


def process_part(cell, peak, found, failed, run, dev):
    """What one process contributes to the result: its peak memory, the
    forbidden modules it loaded, its failed batches or steps, and its
    readings of the trace (per-layer metrics on the card, busy and wall
    seconds, the breakdown)."""
    tr = None
    if run is not None:
        readings = {}
        if dev.type == "cuda":
            readings = {m["name"]: cell.readers[m["name"]].read(run) for m in cell.per_layer}
        tr = dict(readings=readings, busy_s=run.trace.busy_us() * 1e-6, window_s=run.wall_s,
                  breakdown={"device_ops": run.trace.top_ops(),
                             "idle_gaps": run.trace.idle_gaps()})
    return dict(peak=peak, forbidden=found, failed=failed, trace=tr)


def over_ranks(cell, parts):
    """One result's device part from every rank's: the largest peak, the
    union of forbidden modules, the most failures; each per-layer reading
    rank 0's, or the largest over the ranks where its reader sets
    ``OVER_RANKS = "max"``; busy seconds the mean over the cards, the
    traced window and the breakdown rank 0's."""
    out = dict(peak=max(p["peak"] for p in parts),
               forbidden=sorted(set().union(*(p["forbidden"] for p in parts))),
               failed=max(p["failed"] for p in parts), trace=None)
    traces = [p["trace"] for p in parts]
    if all(t is not None for t in traces):
        readings = {}
        for name, v in traces[0]["readings"].items():
            if getattr(cell.readers[name], "OVER_RANKS", None) == "max":
                vs = [t["readings"][name] for t in traces if t["readings"][name] is not None]
                v = max(vs) if vs else None
            readings[name] = v
        out["trace"] = dict(traces[0], readings=readings,
                            busy_s=sum(t["busy_s"] for t in traces) / len(traces))
    return out


# ---------------------------------------------------------------- inference

def run_infer(cell, seed, seconds, tracing, fault, control, dev, t_start, ranks=None):
    cfg, mix, mf = cell.cfg, cell.mix, cell.model
    anchors = torch.as_tensor(ref.make_anchors(cfg), device=dev)
    b, p = mix["batch"], mix["pool"]
    draws = seeded_draws(cell, seed, p + 1, dev)
    sd = weights.draw(mf.param_shapes(cfg), seed, dev)
    calib = to_device(traffic.make_batch(mix, seed, traffic.CALIBRATION, 0), dev)
    mf.calibrate(cfg, sd, calib, anchors, draws[p])
    del calib
    pool = [to_device(traffic.make_batch(mix, seed, traffic.POOL, i), dev) for i in range(p)]
    if dev.type == "cuda":
        sync(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    outputs, cur, hooks, model = {}, {}, [], None
    if not control:
        model = mf.build(cell.program_config(), sd, dev)
        hooks = mf.capture(model, cur)

    def program(batch, u):
        det = mf.infer(model, batch, anchors, u)
        return dict(cur, det=tuple(det))

    def forward(i):
        cur.clear()
        batch, u = pool[i], draws[i]
        if control:
            out = mf.control(cfg, sd, batch, anchors, u)
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
        got = mf.judge(cfg, outputs[i], pool[i], sd, anchors, draws[i])
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
        run = traced_run(cell, stretch, pool, draws, sd, anchors)
    part = over_ranks(cell, [process_part(cell, peak, found, failed, run, dev)])
    return dict(part, attempted=attempted, metrics=metrics, numbers=numbers,
                window_s=window_s, kind=device_kind(dev), count=1)


def device_kind(dev):
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


# ----------------------------------------------------------------- training

@contextlib.contextmanager
def skipped_allreduce(active: bool):
    """The fault ``skip_allreduce``: the port's gradient all-reduce still
    runs, so the ranks stay in step, but this rank throws its sums away and
    keeps its own gradients."""
    if not active:
        yield
        return
    from vision3d_tpu_torch.parallel import mesh

    def reduce_and_discard(params):
        grads = [p.grad for p in params if p.grad is not None]
        if grads:
            dist.all_reduce(torch.cat([g.reshape(-1) for g in grads]))

    saved, mesh.all_reduce_gradients = mesh.all_reduce_gradients, reduce_and_discard
    try:
        yield
    finally:
        mesh.all_reduce_gradients = saved


def rank_param_gap(model) -> float:
    """The largest difference of any parameter between any two ranks."""
    v = torch.cat([p.detach().float().reshape(-1) for p in model.parameters()])
    hi, lo = v.clone(), v.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return float((hi - lo).max())


def run_train(cell, seed, seconds, tracing, fault, control, dev, t_start, ranks=None):
    """Training steps back to back. On several cards (``ranks``) every rank
    runs this on its share of each global batch of ``batch x chips``
    frames, and the reference's steps too; rank 0 returns the result, the
    others None."""
    cfg, mix, mf = cell.cfg, cell.mix, cell.model
    rank, world = (ranks.rank, ranks.world) if ranks else (0, 1)
    anchors = torch.as_tensor(ref.make_anchors(cfg), device=dev)
    b, p = mix["batch"], mix["pool"]
    wlh = cfg["anchors"][0]["wlh"]
    sd = weights.draw(mf.param_shapes(cfg), seed, dev)
    gmix, share = dict(mix, batch=b * world), slice(b * rank, b * (rank + 1))
    pool = [to_device(traffic.make_batch(gmix, seed, traffic.POOL, i, wlh, share), dev)
            for i in range(p)]
    checked = cfg["bench"]["check_steps"]
    if dev.type == "cuda":
        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    attempted = failed = 0
    window_s, stretch, found, run, gap = 0.0, None, forbidden_modules(), None, None
    if control:
        got = mf.reference_steps(cfg, sd, pool[:checked], anchors, quant=True,
                                 over_ranks=ranks is not None)[:4]
        setup_s = time.perf_counter() - t_start
        metrics = {}
    else:
        with skipped_allreduce(fault == "skip_allreduce" and rank == 1):
            model, tx, state, step_fn = mf.train_program(
                cell.program_config(), sd, dev, cfg["bench"]["steps_per_epoch"], anchors)
            named = dict(model.named_parameters())
            start = {k: v.detach().clone() for k, v in named.items()}
            if fault == "dw_scale":
                named[mf.DW_FAULT_LEAF].register_hook(lambda g: 2 * g)

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
            hook = mf.capture_train(model, maps)
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
            if ranks:
                dist.barrier(group=ranks.host)      # every rank starts the window together
            setup_s = time.perf_counter() - t_start
            found = forbidden_modules()
            stretch = (TracedStretch(**cfg["bench"]["trace"][mix["mode"]], dev=dev)
                       if tracing else None)
            pending = None
            t0 = time.perf_counter()
            n = 0
            while True:
                stop = (time.perf_counter() - t0 >= seconds
                        and (stretch is None or stretch.done or n < stretch.start))
                if ranks:
                    stop = ranks.rank0_said(stop)   # rank 0 ends the window for all
                if stop:
                    break
                i = (checked + n) % p
                if stretch:
                    stretch.before(n, i)
                try:
                    loss = step(i)
                except (RuntimeError, ValueError):
                    if ranks:                       # the ranks' collectives would part ways
                        raise
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
            if ranks:
                ranks.settle()
                gap = rank_param_gap(model)
            del model, tx, state, step_fn, named
        # the global batch's frames: every rank runs the same steps; on N
        # cards the rate is also ``train_frames_per_s_xN``, for a cell whose
        # spread asks for a bound of its own
        rate = (b * world * (attempted - failed) / window_s, "frames/s")
        metrics = dict(train_frames_per_s=rate)
        if world > 1:
            metrics[f"train_frames_per_s_x{world}"] = rate
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    found = sorted(set(found) | set(forbidden_modules()))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if stretch is not None and stretch.prof is not None:
        run = traced_run(cell, stretch, pool, None, sd, anchors)
    part = process_part(cell, peak, found, failed, run, dev)
    parts = ranks.gather(part) if ranks else [part]
    del run
    want = mf.reference_steps(cfg, sd, pool[:checked], anchors, over_ranks=ranks is not None)
    if rank != 0:
        return None
    numbers = mf.train_numbers(cfg, got, want)
    if gap is not None:
        numbers["rank_param_gap"] = gap
    res = over_ranks(cell, parts)
    metrics.update(setup_s=(setup_s, "s"), peak_mem_gib=(res["peak"] / 2**30, "GiB"))
    return dict(res, attempted=attempted, metrics=metrics, numbers=numbers, window_s=window_s,
                kind=device_kind(dev), count=world if ranks else 1)


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
    per_index = {}
    for i in dict.fromkeys(stretch.indices):
        u = None if draws is None else draws[i]
        per_index[i] = cell.model.counts(cell.cfg, sd, pool[i], anchors, u)
    return TracedRun(tr, [per_index[i] for i in stretch.indices], stretch.units,
                     stretch.wall_s, cell.cfg)


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


def run_once(cell, seed, args, dev, t_start, ranks=None):
    runner = {"infer": run_infer, "train": run_train}[cell.mix["mode"]]
    return runner(cell, seed, args.seconds, bool(args.trace), args.fault, args.control, dev,
                  t_start, ranks)


def verdict(cell, res):
    checks = {k: {"value": res["numbers"][k], "limit": lim} for k, lim in cell.limits.items()
              if k in res["numbers"]}
    missing = [k for k in cell.limits if k not in res["numbers"]]
    ok = (not missing and res["attempted"] > 0 and res["failed"] == 0
          and all(c["value"] <= c["limit"] for c in checks.values()))
    return ok, checks


def result_line(cell, res, args, dev):
    ok, checks = verdict(cell, res)
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": res["kind"],
              "count": res["count"], "memory_peak_bytes": int(res["peak"])}
    if dev.type == "cuda":
        device["power_limit"] = power_limit()
    line = {"correct": ok, "attempted": res["attempted"], "failed": res["failed"]}
    metrics = {}
    if dev.type == "cuda" and not args.trace:
        names = {m["name"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": u} for k, (v, u) in res["metrics"].items()
                   if k in names}
    tr = res["trace"]
    if args.trace and dev.type == "cuda" and tr is not None:
        for m in cell.per_layer:
            v = tr["readings"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["breakdown"] = tr["breakdown"]
    line["metrics"] = metrics
    line["device"] = device
    line["checks"] = checks
    return line


def readings(cell, args, dev, ranks=None):
    """``--readings N``: N seeds from ``--seed``, one line of numbers each
    (printed by rank 0)."""
    for k in range(args.readings):
        seed = args.seed + k
        res = run_once(cell, seed, args, dev, time.perf_counter(), ranks)
        if res is not None:
            ok, checks = verdict(cell, res)
            print(json.dumps({"seed": seed, "correct": ok, "numbers": res["numbers"],
                              "attempted": res["attempted"], "failed": res["failed"]}),
                  flush=True)
        del res
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def rank_main(payload):
    """One rank of a cell on several cards, in a process that
    ``mesh.launch`` started with the coordinator's address, the world size
    and the rank in its environment: rank r drives card r. Returns rank 0's
    result, None on the others."""
    argv, t_start = payload
    args = parse_args(argv)
    rank, world = int(os.environ["PROCESS_ID"]), int(os.environ["NUM_PROCESSES"])
    dev = torch.device(args.device)
    kw = {}
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{os.environ['COORDINATOR_ADDRESS']}",
                            world_size=world, rank=rank, timeout=RANK_TIMEOUT, **kw)
    try:
        host = dist.new_group(backend="gloo") if dev.type == "cuda" else dist.group.WORLD
        ranks = Ranks(rank, world, host)
        cell = Cell(args.workload, quick=dev.type == "cpu")
        if args.readings:
            return readings(cell, args, dev, ranks)
        return run_once(cell, args.seed, args, dev, t_start, ranks)
    finally:
        dist.destroy_process_group()


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
    if args.fault == "skip_allreduce" and cell.chips < 2:
        print(f"{args.workload}: the fault skip_allreduce needs a cell on several chips",
              file=sys.stderr)
        return 2
    if cell.chips > 1:
        from vision3d_tpu_torch.parallel import mesh

        res = mesh.launch(rank_main, cell.chips, (argv, t_start))
        if args.readings:
            return 0
    else:
        if dev.type == "cuda":
            torch.cuda.set_device(dev if dev.index is not None else 0)
            dev = torch.device("cuda", torch.cuda.current_device())
        if args.readings:
            readings(cell, args, dev)
            return 0
        res = run_once(cell, args.seed, args, dev, t_start)
    found = sorted(set(res["forbidden"]) | set(forbidden_modules()))
    if found:
        print(f"modules of JAX or the JAX package loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    line = result_line(cell, res, args, dev)
    for k, c in line["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"check failed = {res['failed']} of {res['attempted']} (limit 0)", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
