"""The traced stretch: spans around the model's layers, and the reading of
a ``torch.profiler`` trace (CPU + CUDA).

Spans come from the benchmark's own files: a forward pre-hook and a
forward hook on each named submodule that a per-layer metric lists open
and close a ``record_function`` range ``bench:<name>``. The profiler's
trace is exported to a file under ``TMPDIR``, read into memory and deleted
at once. Device time under a span is the time of the kernels whose launch
(the CUDA runtime call with the kernel's correlation id) falls inside the
span on the same host thread.
"""

import bisect
import json
import os
import re
import tempfile

import torch

SPAN = "bench:"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """``record_function`` ranges around every call of the named
    submodules; ``remove()`` takes the hooks off."""

    def __init__(self, model, names):
        self.handles = []
        for name in names:
            mod = model.get_submodule(name)
            stack = []

            def pre(_m, _a, name=name, stack=stack):
                rf = torch.autograd.profiler.record_function(SPAN + name)
                rf.__enter__()
                stack.append(rf)

            def post(_m, _a, _o, stack=stack):
                stack.pop().__exit__(None, None, None)

            self.handles += [mod.register_forward_pre_hook(pre),
                             mod.register_forward_hook(post)]

    def remove(self):
        for h in self.handles:
            h.remove()


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


class Trace:
    """The events of one exported trace: device intervals, kernel launches
    and host spans, in microseconds."""

    def __init__(self, prof):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.remove(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        events = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.kernels = [e for e in self.device if e.get("cat") == "kernel"]
        self.launch = {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
                self.launch[e["args"]["correlation"]] = e
        self.host = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation",
                                                           "cuda_runtime", "cuda_driver")]
        self.spans = [e for e in events if e.get("cat") == "user_annotation"
                      and str(e.get("name", "")).startswith(SPAN)]

    def busy_us(self):
        """The union of the device's busy intervals."""
        total, end = 0.0, None
        for s, e in sorted((ev["ts"], ev["ts"] + ev["dur"]) for ev in self.device):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total

    def kernel_us(self, patterns):
        rx = [re.compile(p) for p in patterns]
        return sum(k["dur"] for k in self.kernels if any(r.search(k["name"]) for r in rx))

    def span_kernel_us(self, names):
        """Device time of the kernels launched inside the spans of
        ``names``."""
        wanted = {SPAN + n for n in names}
        by_tid = {}
        for s in self.spans:
            if s["name"] in wanted:
                by_tid.setdefault(s.get("tid"), []).append((s["ts"], s["ts"] + s["dur"]))
        for iv in by_tid.values():
            iv.sort()
        total = 0.0
        for k in self.kernels:
            lau = self.launch.get(k.get("args", {}).get("correlation"))
            if lau is None or lau.get("tid") not in by_tid:
                continue
            iv = by_tid[lau["tid"]]
            i = bisect.bisect_right(iv, (lau["ts"], float("inf"))) - 1
            if i >= 0 and iv[i][0] <= lau["ts"] <= iv[i][1]:
                total += k["dur"]
        return total

    def top_ops(self, n=10):
        agg = {}
        for k in self.device:
            agg[k["name"]] = agg.get(k["name"], 0.0) + k["dur"]
        return [[name, us * 1e-6] for name, us in
                sorted(agg.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n=10):
        """The longest gaps between device work, each named by the
        innermost host event running at the gap's middle."""
        ivs = sorted((ev["ts"], ev["ts"] + ev["dur"]) for ev in self.device)
        gaps, end = [], None
        for s, e in ivs:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        out = []
        for dur, s, e in gaps[:n]:
            mid = 0.5 * (s + e)
            inner = [h for h in self.host if h["ts"] <= mid <= h["ts"] + h["dur"]]
            name = min(inner, key=lambda h: h["dur"])["name"] if inner else "host: no event"
            out.append([name, dur * 1e-6])
        return out
