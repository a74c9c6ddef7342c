"""``harness/program_spans.py`` and the metrics that read the program's own
spans, on a hand-made Chrome trace: kernels launched from another thread,
idle inside a span that device work partly covers, nested spans of one
name, synchronising calls inside and outside the forward, and no reading
from a program without spans."""

import json

import pytest

from harness import main as M
from harness import program_spans as ps
from harness import trace

MAIN, AUTOGRAD = 1, 2


def span(name, ts, dur, tid=MAIN):
    return dict(ph="X", cat="user_annotation", name="v3d:" + name, ts=ts, dur=dur, tid=tid)


def runtime(name, ts, tid=MAIN, corr=None, dur=1):
    e = dict(ph="X", cat="cuda_runtime", name=name, ts=ts, dur=dur, tid=tid, args={})
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def kernel(corr, ts, dur, name=None):
    return dict(ph="X", cat="kernel", name=name or f"k{corr}", ts=ts, dur=dur, tid=7,
                args={"correlation": corr})


NCCL = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"


# one batch (inference, 0-100 us), a global sum outside every span
# (152-158 us), and one training step's backward, optimizer and gradient
# all-reduce (200-350 us)
EVENTS = [
    span("inference", 0, 100),
    span("plan", 10, 20), span("plan", 12, 8),                # nested, one name
    runtime("cudaLaunchKernel", 15, corr=1), kernel(1, 22, 18),  # 22-40
    span("nms", 50, 40), span("sync", 80, 5),
    runtime("cudaLaunchKernel", 55, corr=2), kernel(2, 60, 10),  # 60-70
    runtime("cudaStreamSynchronize", 81),
    runtime("cudaMemcpyAsync", 105), runtime("cudaStreamSynchronize", 106),  # read-back
    runtime("cudaLaunchKernelExC", 150, corr=8), kernel(8, 152, 6, NCCL),  # 152-158
    span("backward", 200, 100),
    runtime("cudaLaunchKernel", 210, tid=AUTOGRAD, corr=5), kernel(5, 220, 40),  # 220-260
    span("optimizer", 300, 30),
    runtime("cudaLaunchKernel", 301, corr=6), kernel(6, 305, 5),  # 305-310
    span("allreduce", 340, 10),
    runtime("cudaLaunchKernelExC", 341, corr=7), kernel(7, 343, 4, NCCL),  # 343-347
]


class Prof:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


class Run:
    def __init__(self, events, units=1):
        self.trace, self.units = trace.Trace(Prof(events)), units


@pytest.fixture
def tr():
    return trace.Trace(Prof(EVENTS))


def test_backward_kernels_launched_from_another_thread(tr):
    assert ps.kernel_us(tr, "backward") == 0.0
    assert ps.kernel_us(tr, "backward", any_thread=True) == 40.0


def test_kernels_of_a_span_by_name(tr):
    assert ps.kernel_us(tr, "allreduce", match="^nccl") == 4.0
    assert ps.kernel_us(tr, "allreduce", match="^k") == 0.0
    assert ps.kernel_us(tr, "plan", match="^k") == 18.0


def test_idle_inside_a_span_partly_covered(tr):
    assert ps.idle_us(tr, "nms") == 40.0 - 10.0
    assert ps.idle_us(tr, "optimizer") == 30.0 - 5.0


def test_nested_spans_of_one_name_count_once(tr):
    assert ps.kernel_us(tr, "plan") == 18.0
    assert ps.idle_us(tr, "plan") == 20.0 - 8.0


def test_syncs_counted_only_inside_the_forward(tr):
    assert ps.count(tr, "inference") == 1
    assert ps.count(tr, "nms") == 1 and ps.count(tr, "plan") == 0


def test_table_self_time(tr):
    rows = {r[0]: r[1:] for r in ps.table(tr)}
    assert list(rows)[:3] == ["inference", "plan", "nms"]
    calls, dev, idle, self_us, self_idle = rows["inference"]
    assert calls == 1 and dev == 28.0 and idle == 100.0 - 28.0
    assert self_us == 100.0 - 20.0 - 40.0 and self_idle == self_us - 10.0   # k1's 30-40
    assert rows["plan"][:4] == (2, 18.0, 12.0, 20.0)
    assert rows["nms"][3:] == (35.0, 25.0)


READERS = {
    "voxelize_ms.infer": None, "plan_ms.infer": 0.018, "plan_idle_ms.infer": 0.012,
    "nms_idle_ms.infer": 0.030, "host_syncs.infer": 1.0, "fps_idle_ms.infer": None,
    "target_assign_ms.train": None, "backward_ms.train": 0.040,
    "optimizer_idle_ms.train": 0.025, "allreduce_ms.train": 0.004,
    "global_sums_ms.train": 0.006,
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_the_program_spans(name):
    reader = M.load_reader(name)
    assert reader.SUBMODULES == [] and reader.KERNELS == []
    got = reader.read(Run(EVENTS))
    if READERS[name] is None:
        assert got is None
    else:
        assert got == pytest.approx(READERS[name])
        assert reader.read(Run(EVENTS, units=2)) == pytest.approx(READERS[name] / 2)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_without_program_spans(name):
    reader = M.load_reader(name)
    assert reader.read(Run([])) is None
    unnamed = [e for e in EVENTS if e["cat"] != "user_annotation"]   # an older program
    assert reader.read(Run(unnamed)) is None
