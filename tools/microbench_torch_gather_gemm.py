"""Microbench: the rulebook gather-GEMM (kernel B2, ``ops/gather_gemm.py``)
alone, at every shape of one SECOND training step, on a GPU.

Full KITTI geometry, configs/second/all_classes.yaml, batch 8 x 18,000
synthetic points: the real full-tap rulebooks of the step's sparse convs
(``chip_smoke.train_path_layers``: 27 launches, forward and dX). Per
shape, on random inputs, each route the widths allow (``mma``: tensor
cores, bf16 with C % 16 == 0 and Cout % 8 == 0; ``fma``: the float32-FMA
design) is held against the plain version (``ops.sparse.
conv_rulebook_apply``; 2e-2 of the scale in bf16, 1e-4 in float32) and
then timed (CUDA-event median); printed beside the bound (each input read
once, the output written once, 2*C*Cout flops per hit, over the H100's
peaks) and the ratio. Ends with the per-step sums (each shape times its
launches per step) for the default route and for fma alone.

    python tools/microbench_torch_gather_gemm.py [--iters 10] [--dtype bfloat16]
"""

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import cuda_ms, gather_gemm_bound_ms, train_path_layers  # noqa: E402
from vision3d_tpu_torch.config import Config  # noqa: E402
from vision3d_tpu_torch.ops import sparse as sp  # noqa: E402
from vision3d_tpu_torch.ops.gather_gemm import gather_gemm, route_of  # noqa: E402
from vision3d_tpu_torch.synthetic import kitti_like_batch  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("microbench_torch_gather_gemm: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    dtype = getattr(torch, args.dtype)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    cfg = Config.from_yaml(str(ROOT / "configs/second/all_classes.yaml"))
    pts, num = kitti_like_batch(0, 8, 18000)
    convs, _ = train_path_layers(cfg, torch.from_numpy(pts).to(dev),
                                 torch.from_numpy(num).to(dev))
    gen = torch.Generator(device=dev).manual_seed(1)
    totals = {"default": 0.0, "fma": 0.0, "bound": 0.0}
    failed = []
    for name, count, n, c, cout, kd, rb in convs:
        b, m = rb.shape[0], rb.shape[1] // kd
        feats = torch.randn((b, n, c), generator=gen, device=dev)
        w = torch.randn((kd * c, cout), generator=gen, device=dev) / (kd * c) ** 0.5
        hits = int((rb < n).sum())
        bound, by = gather_gemm_bound_ms(b, n, m, c, cout, kd, hits, dtype)
        ref = sp.conv_rulebook_apply(feats, rb, w, dtype)
        scale = float(ref.abs().max())
        default = route_of(dtype, c, cout)
        for route in dict.fromkeys((default, "fma")):
            got = gather_gemm(feats, rb, w, dtype, route=route)
            err = float((got - ref).abs().max())
            ok = bool(((got - ref).abs() <= tol * scale + tol * ref.abs()).all())
            del got
            if not ok:
                failed.append(f"{name} {route}")
            ms = cuda_ms(lambda: gather_gemm(feats, rb, w, dtype, route=route),
                         reps=args.iters)
            if route == default:
                totals["default"] += count * ms
            if route == "fma":
                totals["fma"] += count * ms
            print(f"{name:22s} x{count} B={b} N={n} M={m} K={kd} hits={hits} {route} "
                  f"{ms:8.4f} ms bound {bound:.4f} ({by}) x{ms / bound:7.1f} "
                  f"err {err:.3g} scale {scale:.3g}{'' if ok else ' DISAGREES'}",
                  flush=True)
        totals["bound"] += count * bound
        del ref
    print(f"per step (27 launches): default routes {totals['default']:.4f} ms, fma only "
          f"{totals['fma']:.4f} ms, bound {totals['bound']:.4f} ms")
    if failed:
        print(f"kernel disagrees with the plain version: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
