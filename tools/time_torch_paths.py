"""Times the port's paths on the card through the ``chip_smoke.py`` of a
checkout: SECOND's voxel inference p50 (its phase 3), SECOND's training
step p50 (phase 5) and PV-RCNN inference p50, one stage and two, with
the two-stage forward's FPS time (phase 8a). Each phase runs with its own
checks. Prints the card's name and power limit and one line
``AB {json}``.

    python tools/time_torch_paths.py                         # the checkout in the cwd
    python tools/time_torch_paths.py --compare PARENT CHANGE # PARENT, CHANGE, CHANGE, PARENT

``--compare`` runs the two checkout directories in turn in one process
each, on one card, so a difference between them can be read against the
spread of each side's own two runs.
"""

import argparse
import json
import os
import subprocess
import sys


def time_paths():
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs

    cs.kernels.build(cs.kernels.KERNELS)
    dev = torch.device("cuda")
    cfg = cs.Config.from_yaml(str(cs.CONFIG)).replace(compute_dtype="bfloat16")
    pts, num = cs.kitti_like_batch(0, cs.BATCH, cs.POINTS)
    points, num_t = torch.from_numpy(pts).to(dev), torch.from_numpy(num).to(dev)
    sd = cs.convert.state_dict_from_flax(cs.convert.load_npz(cs.WEIGHTS))
    model, anchors = cs.create_second(cfg, device=dev, state_dict=sd)
    want = {"zwin_conv": 6, "zwin_conv.fma": 1, "zwin_conv.mma": 5,
            **cs.epilogue_launches(cfg)}
    e2e = cs.end_to_end_phase(model, anchors, points, num_t, want)
    del model
    torch.cuda.empty_cache()
    train = cs.training_phase(cfg, dev, {"zwin_conv": 0, "gather_rows": 14,
                                         "gather_gemm": 27, "gather_gemm.mma": 26,
                                         "gather_gemm.fma": 1})
    torch.cuda.empty_cache()
    pv = cs.pvrcnn_phase(cfg, dev, want)
    print("AB " + json.dumps({"voxel_p50_ms": e2e["latency_ms_p50"],
                              "train_step_p50_ms": train["step_ms_p50"],
                              "pvrcnn_one_stage_p50_ms": pv["p50_one_stage_ms"],
                              "pvrcnn_two_stage_p50_ms": pv["p50_two_stage_ms"],
                              "fps_ms": pv["stage_ms"]["fps"]}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--compare", nargs=2, metavar=("PARENT", "CHANGE"))
    args = ap.parse_args()
    if not args.compare:
        time_paths()
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    parent, change = args.compare
    for side, cwd in (("parent", parent), ("change", change), ("change", change),
                      ("parent", parent)):
        out = subprocess.run([sys.executable, os.path.abspath(__file__)], cwd=cwd,
                             capture_output=True, text=True)
        if out.returncode:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
            raise SystemExit(f"{side} ({cwd}) exited {out.returncode}")
        line = next(x for x in out.stdout.splitlines() if x.startswith("AB "))
        print(f"{side} {line}", flush=True)


if __name__ == "__main__":
    main()
