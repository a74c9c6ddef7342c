"""Export a vision3d_tpu SECOND checkpoint for the PyTorch port.

Restores an orbax checkpoint through the JAX package
(``vision3d_tpu.training.checkpoint.load_checkpoint``) and writes its
params and batch_stats as one float32 ``.npz`` keyed by flax path
(``params/cnn/SubMConv_0/kernel``, ``batch_stats/rpn/...``). The port reads
that file with ``vision3d_tpu_torch.convert`` and needs no JAX.

    python tools/export_torch_weights.py \
        --ckpt ckpts_synth_r05_3c/epoch_11 \
        --config configs/second/all_classes.yaml \
        --out vision3d_tpu_torch/weights/second_all_classes_epoch11.npz

Runs on the CPU.
"""

import argparse
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def flatten(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v, dtype=np.float32)
    return out


def restore_variables(ckpt: str, config: str) -> dict:
    """{"params": ..., "batch_stats": ...} of the checkpoint, as numpy."""
    import jax

    from vision3d_tpu.config import Config
    from vision3d_tpu.training.checkpoint import load_checkpoint
    from vision3d_tpu.training.train import create_train_state

    cfg = Config.from_yaml(config)
    # an abstract target: shapes and dtypes only, so the full-geometry
    # model is traced but never compiled or run here
    target = jax.eval_shape(
        lambda: create_train_state(cfg, jax.random.PRNGKey(0))[2])
    state = load_checkpoint(ckpt, target)
    return jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats})


def export(ckpt: str, config: str, out: str) -> dict:
    """Write the checkpoint's variables to ``out``; returns the flat dict."""
    flat = flatten(restore_variables(ckpt, config))
    pathlib.Path(out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, **flat)
    return flat


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", default=str(ROOT / "ckpts_synth_r05_3c/epoch_11"))
    ap.add_argument("--config",
                    default=str(ROOT / "configs/second/all_classes.yaml"))
    ap.add_argument("--out", default=str(
        ROOT / "vision3d_tpu_torch/weights/second_all_classes_epoch11.npz"))
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    flat = export(args.ckpt, args.config, args.out)
    n = sum(v.size for v in flat.values())
    print(f"wrote {args.out}: {len(flat)} arrays, {n} values")


if __name__ == "__main__":
    main()
