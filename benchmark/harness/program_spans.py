"""The program's own spans in a traced stretch.

The port names its layers itself: ``vision3d_tpu_torch.training.profiler.
annotate(name)`` opens a ``record_function`` range ``v3d:<name>`` (cat
``user_annotation``) while a profiler records, each batch's spans under
``v3d:inference`` and each training step's under ``v3d:train_step``. This
module reads those ranges from a ``trace.Trace``, per span name:

- ``kernel_us``: device time of the kernels launched inside the span, on
  the span's host thread (as ``Trace.span_kernel_us``), or with
  ``any_thread`` on any thread while the span is open (autograd launches
  the backward's kernels from its own device thread), all or those a
  pattern names;
- ``idle_us``: the span's intervals less the union of device work (kernels,
  copies, fills);
- ``count``: runtime calls of the given names made on the span's thread
  inside it.

A span nested in another of its name counts once. A program without these
spans (an older commit) gives None for every reading, and a reader then
reports nothing. ``table`` gives every span's calls, device time, idle
time and self time, for the profile tools under ``tools/``.
"""

import bisect
import re

PREFIX = "v3d:"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy")
RUNTIME = ("cuda_runtime", "cuda_driver")


def _union(ivs):
    """Sorted disjoint intervals covering ``ivs``."""
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def _overlap(a, b):
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _inside(ivs, t):
    i = bisect.bisect_right(ivs, (t, float("inf"))) - 1
    return i >= 0 and ivs[i][0] <= t <= ivs[i][1]


def spans(tr, name=None):
    """The trace's program spans (events), all or those of ``name``."""
    out = [e for e in tr.host if e.get("cat") == "user_annotation"
           and str(e.get("name", "")).startswith(PREFIX)]
    return out if name is None else [e for e in out if e["name"] == PREFIX + name]


def intervals(tr, name, any_thread=False):
    """{thread: sorted disjoint intervals} of the spans of ``name`` (with
    ``any_thread`` one list under the key None), or None without one."""
    found = spans(tr, name)
    if not found:
        return None
    by_tid = {}
    for e in found:
        by_tid.setdefault(None if any_thread else e.get("tid"), []).append(
            (e["ts"], e["ts"] + e["dur"]))
    return {tid: _union(ivs) for tid, ivs in by_tid.items()}


def busy(tr):
    return _union((d["ts"], d["ts"] + d["dur"]) for d in tr.device)


def kernel_us(tr, name, any_thread=False, match=None):
    """Device µs of the kernels launched inside the spans of ``name`` (with
    ``match`` only those whose name the regular expression finds)."""
    by_tid = intervals(tr, name, any_thread)
    if by_tid is None:
        return None
    total = 0.0
    for k in tr.kernels:
        if match is not None and not re.search(match, k["name"]):
            continue
        lau = tr.launch.get(k.get("args", {}).get("correlation"))
        if lau is None:
            continue
        ivs = by_tid.get(None if any_thread else lau.get("tid"))
        if ivs and _inside(ivs, lau["ts"]):
            total += k["dur"]
    return total


def idle_us(tr, name):
    """µs inside the spans of ``name`` in which the device ran nothing."""
    by_tid = intervals(tr, name, any_thread=True)
    if by_tid is None:
        return None
    ivs = by_tid[None]
    return sum(e - s for s, e in ivs) - _overlap(ivs, busy(tr))


def count(tr, name, calls=SYNCS):
    """Runtime calls named in ``calls`` made inside the spans of ``name``,
    on the span's thread."""
    by_tid = intervals(tr, name)
    if by_tid is None:
        return None
    return sum(1 for e in tr.host if e.get("cat") in RUNTIME and e.get("name") in calls
               and e.get("tid") in by_tid and _inside(by_tid[e["tid"]], e["ts"]))


def self_intervals(tr):
    """{name: sorted disjoint intervals} in which ``v3d:<name>`` is the
    innermost open program span of its thread."""
    out = {}
    by_tid = {}
    for e in spans(tr):
        by_tid.setdefault(e.get("tid"), []).append(e)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        children = {id(e): [] for e in evs}
        stack = []
        for e in evs:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"] + e["dur"]:
                stack.pop()
            if stack:
                children[id(stack[-1])].append((e["ts"], e["ts"] + e["dur"]))
            stack.append(e)
        for e in evs:
            cur = e["ts"]
            pieces = []
            for s, end in _union(children[id(e)]):
                if s > cur:
                    pieces.append((cur, s))
                cur = max(cur, end)
            if e["ts"] + e["dur"] > cur:
                pieces.append((cur, e["ts"] + e["dur"]))
            out.setdefault(e["name"][len(PREFIX):], []).extend(pieces)
    return {name: _union(ivs) for name, ivs in out.items()}


def table(tr):
    """One row a span name, in order of first appearance: (name, calls,
    device µs of kernels launched on any thread while it is open, idle µs
    inside it, self µs (its time less its child spans'), idle µs in its
    self time)."""
    dev = busy(tr)
    own = self_intervals(tr)
    rows = []
    for name in dict.fromkeys(e["name"][len(PREFIX):] for e in
                              sorted(spans(tr), key=lambda e: e["ts"])):
        mine = own.get(name, [])
        width = sum(e - s for s, e in mine)
        rows.append((name, len(spans(tr, name)), kernel_us(tr, name, any_thread=True),
                     idle_us(tr, name), width, width - _overlap(mine, dev)))
    return rows


def format_table(tr, units, per="batch"):
    """``table`` as text, every time in ms per ``per`` over ``units`` of
    them."""
    lines = [f"{'span':<16}{'calls':>8}{'device ms':>12}{'idle ms':>10}{'self ms':>10}"
             f"{'self idle ms':>14}   (ms a {per}, over {units})"]
    for name, calls, dev, idle, self_us, self_idle in table(tr):
        lines.append(f"{PREFIX + name:<16}{calls / units:>8.1f}{dev * 1e-3 / units:>12.3f}"
                     f"{idle * 1e-3 / units:>10.3f}{self_us * 1e-3 / units:>10.3f}"
                     f"{self_idle * 1e-3 / units:>14.3f}")
    return "\n".join(lines)
