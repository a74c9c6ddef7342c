"""Microbench: the z-window conv kernels of the PyTorch port on one set of
rulebooks, on a GPU (counterpart of tools/microbench_zwin.py).

Full KITTI geometry, configs/second/all_classes.yaml, batch 8 x 18,000
synthetic points: the real (start, pattern) rulebooks of the forward's six
z-window layers (``chip_smoke.path_layers``). Per layer, in bf16 (or --dtype float32), CUDA-event
medians of
  * v2: ``zwin_conv`` (csrc/zwin_conv.cu), which reads (feats, start,
    pattern) itself: the kernel the model runs, on each route the widths
    allow ("mma": tensor cores, bf16 with C % 16 == 0; "fma": the
    float32-FMA design);
  * v1 and v3: ``zwin_align_gemm_v1`` / ``_v3`` (csrc/zwin_align_gemm.cu)
    on already gathered windows: the kernel alone on each route the widths
    allow (the same rule), and the whole ``conv_zwin_apply_v1`` / ``_v3``
    with its window gather and mask build in plain PyTorch;
  * the plain version ``ops.sparse.conv_zwin_apply``.
Every kernel's output is held against the plain version's (1e-4 of the
scale in float32, 2e-2 in bf16) before it is timed. Printed beside the
bound, over the H100's peaks: for v2 and the plain version each input read
once, the output written once, 2*C*Cout flops per active tap; for v1 and
v3 ``chip_smoke.align_bound_ms``, the masks, the rows they select and the
weight read once (every gathered window read once beside it). Ends with
the per-forward sums (each layer times its launches; "as routed" sums each
layer on the route the wrapper picks).

    python tools/microbench_torch_zwin.py [--iters 10] [--dtype bfloat16]
"""

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import align_bound_ms, cuda_ms, path_layers, zwin_bound_ms  # noqa: E402
from vision3d_tpu_torch.config import Config  # noqa: E402
from vision3d_tpu_torch.ops import sparse as sp  # noqa: E402
from vision3d_tpu_torch.ops import zwin_conv as zw  # noqa: E402
from vision3d_tpu_torch.ops.gather_gemm import route_of  # noqa: E402
from vision3d_tpu_torch.synthetic import kitti_like_batch  # noqa: E402

K3 = (3, 3, 3)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("microbench_torch_zwin: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    dtype = getattr(torch, args.dtype)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    cfg = Config.from_yaml(str(ROOT / "configs/second/all_classes.yaml"))
    pts, num = kitti_like_batch(0, 8, 18000)
    layers = path_layers(cfg, torch.from_numpy(pts).to(dev), torch.from_numpy(num).to(dev))
    gen = torch.Generator(device=dev).manual_seed(0)
    totals = {}
    failed = []
    for name, count, c, cout, n, start, pattern in layers:
        b, m = start.shape[0], start.shape[1] // 9
        feats = torch.randn((b, n, c), generator=gen, device=dev)
        w = torch.randn((27 * c, cout), generator=gen, device=dev) / (27 * c) ** 0.5
        ref = sp.conv_zwin_apply(feats, start, pattern, w, K3, dtype)
        scale = float(ref.abs().max())
        bound, by, taps = zwin_bound_ms(b, n, c, cout, start, pattern, dtype)
        g_km = zw.gather_windows_km(feats, start, dtype)
        masks = {"v1": zw.pair_masks(pattern, m, dtype), "v3": zw.shift_masks(pattern, m, dtype)}
        routed = route_of(dtype, c, cout)
        routes = dict.fromkeys((routed, "fma"))
        runs = {f"v2 zwin_conv {r}":
                (lambda r=r: zw.zwin_conv(feats, start, pattern, w, K3, dtype, route=r))
                for r in routes}
        bounds = {}
        for v, fn, apply in (("v1", zw.zwin_align_gemm_v1, zw.conv_zwin_apply_v1),
                             ("v3", zw.zwin_align_gemm_v3, zw.conv_zwin_apply_v3)):
            runs.update({f"{v} kernel {r}":
                         (lambda fn=fn, v=v, r=r: fn(g_km, masks[v], w, route=r))
                         for r in routes})
            runs[f"{v} gather+masks+kernel"] = (
                lambda apply=apply: apply(feats, start, pattern, w, K3, dtype))
            bounds[v] = align_bound_ms(v, g_km, masks[v], cout, dtype)
        runs["plain"] = lambda: sp.conv_zwin_apply(feats, start, pattern, w, K3, dtype)
        for label, fn in runs.items():
            got = fn()
            err = float((got - ref).abs().max())
            ok = bool(((got - ref).abs() <= tol * scale + tol * ref.abs()).all())
            del got
            if not ok:
                failed.append(f"{name} {label}")
            ms = cuda_ms(fn, reps=args.iters)
            totals[label] = totals.get(label, 0.0) + count * ms
            if label.endswith(f" {routed}"):   # the launches as the wrapper routes them
                key = f"{label[:-len(routed)]}as routed"
                totals[key] = totals.get(key, 0.0) + count * ms
            lb, lby, every, _ = bounds.get(label[:2], (bound, by, None, None))
            print(f"{name:16s} x{count} B={b} N={n} M={m} taps={taps} {label:24s} "
                  f"{ms:8.4f} ms bound {lb:.4f} ({lby}"
                  f"{'' if every is None else f'; every window {every:.4f}'}) "
                  f"x{ms / lb:7.1f} err {err:.3g} scale {scale:.3g}"
                  f"{'' if ok else ' DISAGREES'}", flush=True)
        for key, ms in (("bound", bound), *((f"{v} bound", bounds[v][0]) for v in bounds),
                        *((f"{v} bound every window", bounds[v][2]) for v in bounds)):
            totals[key] = totals.get(key, 0.0) + count * ms
        del ref
    for label, ms in totals.items():
        print(f"per forward (6 launches) {label:24s} {ms:8.4f} ms")
    if failed:
        print(f"kernel disagrees with the plain version: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
