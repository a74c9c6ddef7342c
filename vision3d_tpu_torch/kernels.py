"""Build and load the port's CUDA kernels.

Each kernel has a plain C entry point ``<name>_launch`` in one
``csrc/<source>.cu`` (its own ``<name>.cu`` unless ``SOURCES`` names
another: the two z-window align kernels share a file). A source is
compiled with ``nvcc`` for ``sm_90a`` into ``build/lib<source>-<hash>.so``
under this package at first use (the hash of the source and of every
``csrc/`` header it includes keeps a stale library from being loaded) and
bound with ``ctypes``. Nothing is built when a module is imported;
``build()`` compiles several sources at once, one ``nvcc`` process each,
under the span ``v3d:build``. ``launch()`` calls a kernel's entry point and
raises on a CUDA error; ``LAUNCHES`` counts the launches of each kernel,
and of each route ``<name>.<route>`` of a kernel with several (``ROUTES``:
one entry point that takes the route as an argument).
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

from vision3d_tpu_torch.training.profiler import annotate

PACKAGE = Path(__file__).resolve().parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "build"
KERNELS = ("zwin_conv", "gather_gemm", "gather_rows", "column_conv",
           "zwin_align_v1", "zwin_align_v3", "ball_query", "voxel_query", "fps",
           "bn_relu")
SOURCES = {"zwin_align_v1": "zwin_align_gemm", "zwin_align_v3": "zwin_align_gemm"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

# route names in the order of the entry point's route argument
ROUTES = {"gather_gemm": ("fma", "mma"), "zwin_conv": ("fma", "mma"),
          "column_conv": ("fma", "mma"), "zwin_align_v1": ("fma", "mma"),
          "zwin_align_v3": ("fma", "mma"), "fps": ("reg", "smem", "global"),
          "bn_relu": ("f32", "bf16")}

LAUNCHES = {name: 0 for name in KERNELS}
LAUNCHES.update({f"{name}.{r}": 0 for name, routes in ROUTES.items() for r in routes})

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


def source_of(name: str) -> str:
    return SOURCES.get(name, name)


def _includes(path: Path, seen: dict) -> dict:
    """``path`` and every ``#include "..."`` file under ``csrc/`` it reaches,
    as {path: bytes}."""
    text = path.read_bytes()
    seen[path] = text
    for inc in re.findall(rb'^\s*#\s*include\s*"([^"]+)"', text, re.M):
        dep = CSRC / inc.decode()
        if dep.is_file() and dep not in seen:
            _includes(dep, seen)
    return seen


def so_path(source: str) -> Path:
    digest = hashlib.sha1()
    for text in _includes(CSRC / f"{source}.cu", {}).values():
        digest.update(text)
    return BUILD / f"lib{source}-{digest.hexdigest()[:12]}.so"


def build(names=KERNELS) -> dict:
    """Compile the source of every kernel in ``names`` that is not built
    yet, all in parallel. Returns {source: ptxas/nvcc log}; raises if any
    build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    logs, failed = {}, []
    with annotate("build"):
        for name in dict.fromkeys(source_of(n) for n in names):
            out = so_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".tmp{os.getpid()}")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, out)
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
    """The library that holds the kernel, built on first use."""
    source = source_of(name)
    lib = _loaded.get(source)
    if lib is None:
        build((source,))
        lib = ctypes.CDLL(str(so_path(source)))
        _loaded[source] = lib
    return lib


def call(name: str, entry: str, argtypes, *args):
    """Call the C function ``entry`` of kernel ``name``'s library, which
    returns a cudaError_t, and raise if it is not 0."""
    lib = load(name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    err = fn(*args)
    if err:
        err_fn = getattr(lib, f"{source_of(name)}_error_string")
        err_fn.argtypes, err_fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{entry} failed: " + err_fn(err).decode())


def launch(name: str, argtypes, *args, route=None):
    """Call ``<name>_launch(*args)`` (a C function that returns the
    launch's cudaError_t), raise if the launch was refused, and count it,
    under ``<name>.<route>`` too when a route is given."""
    call(name, f"{name}_launch", argtypes, *args)
    LAUNCHES[name] += 1
    if route is not None:
        LAUNCHES[f"{name}.{route}"] += 1
