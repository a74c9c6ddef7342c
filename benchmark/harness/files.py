"""The benchmark's own files, found by name: a per-layer metric's reader
``metrics/<name>.py`` and a model's file ``models/<name>.py``.

A model file holds everything the harness needs of one architecture: its
parameter shapes, its batch-norm calibration, its per-batch draws, how the
program is built and driven and what is hooked out of it, the reference's
control, judge and work counts, and for a model that trains its program
step and reference steps (``API``, by the traffic's mode). A model that a
later change adds is a new file here, with no edit to the harness.
"""

import importlib.util
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
METRICS = BENCH / "metrics"
MODELS = BENCH / "models"
READER_API = ("SUBMODULES", "KERNELS", "read")
COMMON_API = ("param_shapes", "draws", "counts")
API = {"infer": COMMON_API + ("calibrate", "build", "capture", "infer", "control", "judge"),
       "train": COMMON_API + ("train_program", "capture_train", "reference_steps",
                              "train_numbers")}

_loaded = {}


def _load(path: Path, prefix: str, attrs):
    mod = _loaded.get(path)
    if mod is None:
        name = f"{prefix}_{path.stem.replace('.', '_').replace('-', '_')}"
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    missing = [a for a in attrs if not hasattr(mod, a)]
    if missing:
        raise AttributeError(f"{path.name} lacks {', '.join(missing)}")
    return mod


def reader(name: str):
    path = METRICS / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"per-layer metric {name!r} has no reader {path.relative_to(BENCH.parent)}")
    return _load(path, "bench_metric", READER_API)


def model(name: str, mode: str = "infer", directory: Path = MODELS):
    """The model file ``<directory>/<name>.py``, with the functions that
    ``mode`` (``infer`` or ``train``) calls."""
    directory = Path(directory)
    path = directory / f"{name}.py"
    if not path.is_file():
        shown = directory.relative_to(BENCH.parent) if directory.is_relative_to(BENCH.parent) \
            else directory
        have = sorted(p.name for p in directory.glob("*.py"))
        raise KeyError(f"unknown model {name!r}: {shown}/ holds {', '.join(have) or 'no file'}")
    return _load(path, "bench_model", API[mode])
