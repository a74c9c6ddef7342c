"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C entry point. It is
compiled with ``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so``
under this package at first use (the hash of the source keeps a stale
library from being loaded) and bound with ``ctypes``. Nothing is built
when a module is imported; ``build()`` compiles several kernels at once,
one ``nvcc`` process each. ``launch()`` calls a kernel's
``<name>_launch`` entry point and raises on a CUDA error; ``LAUNCHES``
counts the launches of each kernel.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "build"
KERNELS = ("zwin_conv", "gather_gemm", "gather_rows")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

LAUNCHES = {name: 0 for name in KERNELS}

_loaded = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise FileNotFoundError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def so_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def build(names=KERNELS) -> dict:
    """Compile every kernel in ``names`` that is not built yet, all in
    parallel. Returns {name: ptxas/nvcc log}; raises if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = so_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(so_path(name)))
        _loaded[name] = lib
    return lib


def launch(name: str, argtypes, *args):
    """Call ``<name>_launch(*args)`` (a C function that returns the
    launch's cudaError_t), raise if the launch was refused, and count it."""
    lib = load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        err_fn = getattr(lib, f"{name}_error_string")
        err_fn.argtypes, err_fn.restype = [ctypes.c_int], ctypes.c_char_p
    err = fn(*args)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + getattr(lib, f"{name}_error_string")(err).decode())
    LAUNCHES[name] += 1
