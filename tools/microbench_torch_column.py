"""Microbench: the column conv (kernel B3, ``ops/column_conv.py``) alone, at
every shape of the column backend, on a GPU.

Full KITTI geometry, configs/second/all_classes.yaml, batch 8 x 18,000
synthetic points: the real column rulebooks and active sites of the nine
column conv shapes (``chip_smoke.column_path_layers``, the plan run through
all four stages). Per shape, on random values at the real active sites
(zeros elsewhere, as the model's rows are), in the compute dtype, as the
model passes them (so no cast is timed), each route the widths allow
(``mma``: tensor cores on tiles of the active (column, zo) sites, bf16 with
C % 16 == 0; ``fma``: the float32-FMA design) is held against the plain
version (``ops.column_sparse.column_conv_dz``; 2e-2 of the scale in bf16,
1e-4 in float32) and then timed (CUDA-event median); printed beside the
bound (each input read once, the dense-z output written once, 2*C*Cout
flops per tap with an active input, over the H100's peaks) and the ratio.
``--cols-per-block`` also times the "mma" route at other runs of output
columns per block than its rule's (``ops.column_conv.cols_per_block``). Ends with the per-forward
sums (each shape times its launches) at ``dense_from_stage`` 2 (6
launches) and 4 (14).

    python tools/microbench_torch_column.py [--iters 10] [--dtype bfloat16]
        [--cols-per-block 32 64]
"""

import argparse
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import _bound, column_path_layers, cuda_ms  # noqa: E402
from vision3d_tpu_torch.config import Config  # noqa: E402
from vision3d_tpu_torch.ops import column_conv as cc  # noqa: E402
from vision3d_tpu_torch.ops import column_sparse as csp  # noqa: E402
from vision3d_tpu_torch.ops.gather_gemm import route_of  # noqa: E402
from vision3d_tpu_torch.synthetic import kitti_like_batch  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--cols-per-block", type=int, nargs="*", default=[],
                    help="other runs of output columns per block for the mma route")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("microbench_torch_column: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    dtype = getattr(torch, args.dtype)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    cfg = Config.from_yaml(str(ROOT / "configs/second/all_classes.yaml"))
    pts, num = kitti_like_batch(0, 8, 18000)
    layers, _ = column_path_layers(cfg, torch.from_numpy(pts).to(dev),
                                   torch.from_numpy(num).to(dev))
    gen = torch.Generator(device=dev).manual_seed(2)
    totals = {}
    failed = []
    for layer in layers:
        name, c, cout, d, n = (layer[k] for k in ("shape", "C", "Cout", "D", "N"))
        kernel, sz, pz, rb, site = (layer[k] for k in
                                    ("kernel", "stride_z", "pad_z", "rb", "site"))
        counts = (layer["launches_per_forward"], layer["launches_df4"])
        kz, k2 = kernel[0], kernel[1] * kernel[2]
        b, m = rb.shape[0], rb.shape[1] // k2
        d_out = csp.conv_out_depth(d, kz, sz, pz)
        # in the compute dtype, as the model's layers pass their rows
        feats = (torch.randn((b, n, d, c), generator=gen, device=dev)
                 * site[..., None]).reshape(b, n, d * c).to(dtype)
        w = torch.randn((kz * k2 * c, cout), generator=gen, device=dev) / (kz * k2 * c) ** 0.5
        zt = F.pad(site, (pz, pz, 0, 1))
        win = torch.gather(zt, 1, rb.long()[..., None].expand(b, m * k2, zt.shape[-1]))
        taps = int(win.unfold(-1, kz, sz).sum())
        del zt, win
        esize = torch.finfo(dtype).bits // 8
        nbytes = ((feats.numel() + w.numel()) * esize + rb.numel() * 4
                  + b * m * d_out * cout * 4)
        bound, by = _bound(nbytes, 2 * c * cout * taps, dtype)
        ref = csp.column_conv_dz(feats, rb, w, kernel, d, c, sz, pz, dtype)
        scale = float(ref.abs().max())
        default = route_of(dtype, c, cout)
        runs = [(r, None) for r in dict.fromkeys((default, "fma"))]
        if default == "mma":
            runs += [("mma", cols) for cols in args.cols_per_block]
        times = {}
        for route, cols in runs:
            cc.COLS_PER_BLOCK = cols
            label = route if cols is None else f"mma cols {cols}"
            fn = (lambda r=route: cc.column_conv(feats, rb, w, kernel, d, c, sz, pz,
                                                 dtype, route=r))
            got = fn()
            err = float((got - ref).abs().max())
            ok = bool(((got - ref).abs() <= tol * scale + tol * ref.abs()).all())
            del got
            if not ok:
                failed.append(f"{name} {label}")
            times[label] = ms = cuda_ms(fn, reps=args.iters)
            print(f"{name:22s} x{counts[0]}/{counts[1]} B={b} N={n} M={m} D={d}->{d_out} "
                  f"taps={taps} {label:12s} {ms:8.4f} ms bound {bound:.4f} ({by}) "
                  f"x{ms / bound:7.1f} err {err:.3g} scale {scale:.3g}"
                  f"{'' if ok else ' DISAGREES'}", flush=True)
        cc.COLS_PER_BLOCK = None
        # per-forward sums: the rule's routes, FMA only, each forced run of
        # columns (on the shapes the rule sends to "mma"), and the bound
        sums = {"default": times[default], "fma only": times["fma"], "bound": bound}
        sums.update({f"mma cols {cols}": times.get(f"mma cols {cols}", times[default])
                     for cols in args.cols_per_block})
        for label, ms in sums.items():
            for dfs, count in zip((2, 4), counts):
                totals[(label, dfs)] = totals.get((label, dfs), 0.0) + count * ms
        del ref
    for (label, dfs), ms in sorted(totals.items(), key=lambda kv: kv[0][1]):
        print(f"per forward at dense_from_stage {dfs} ({6 if dfs == 2 else 14} launches) "
              f"{label:14s} {ms:9.4f} ms")
    if failed:
        print(f"kernel disagrees with the plain version: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
