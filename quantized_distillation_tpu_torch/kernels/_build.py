"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain ``extern "C"`` interface, loaded with ``ctypes``. Libraries are
built at first use into ``quantized_distillation_tpu_torch/_build/`` under a
name keyed by a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. :func:`build_all` starts one
``nvcc`` per source, all at once. A failed build raises; nothing falls back.

Host code (``csrc/<name>.cpp``: the ``.qdt`` codec) compiles the same way
with ``g++`` (:func:`load_host`). Both builds run under a file lock, since
several processes (test workers, the ranks of a mesh) may load a library
at once.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import json
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, Iterator

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("dequant_matmul", "topk_fused", "beam_combine", "fake_quant", "grouped_matmul",
           "lstm_cell")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources(name: str) -> list:
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def start_nvcc(source: Path, out) -> subprocess.Popen:
    """Start ``nvcc`` with the port's flags for one ``.cu`` file into the
    shared library ``out``; the log is on the process's ``stdout``."""
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _start(name: str, out: Path):
    """Start ``nvcc`` for one source into a temporary file beside ``out``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    return name, out, tmp, start_nvcc(CSRC / f"{name}.cu", tmp)


@contextlib.contextmanager
def _file_lock(name: str) -> Iterator[None]:
    """This process's thread lock and the file lock ``_build/<name>.lock``
    (``fcntl``, released when the file closes, also when the process dies),
    so that one thread of one process builds at a time."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _lock, open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield


def build_all(names: Iterable[str] = KERNELS, force: bool = False) -> Dict[str, str]:
    """Compile every kernel library that is not built yet (with ``force``,
    every one), one ``nvcc`` per source, all started together, under a file
    lock: processes that load a kernel for the first time at once (the ranks
    of a mesh) build each library once, and the later ones find it built.
    Returns each compiler log (``-Xptxas -v`` prints registers, shared
    memory and spills per kernel); an empty dict when all were built
    already."""
    with _file_lock("kernels"):
        jobs = [_start(n, _lib_path(n)) for n in names if force or not _lib_path(n).exists()]
        logs, errors = {}, []
        for name, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            logs[name] = log
            if proc.returncode != 0:
                os.unlink(tmp)
                errors.append(f"nvcc failed for {name}.cu:\n{log}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(path))
    return lib


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library of ``csrc/<name>.cpp``, compiled with ``g++``
    at first use into a name keyed by the source's hash; raises if it does
    not build."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cpp"
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + src.read_bytes())
    path = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    with _file_lock(name):
        if not path.exists():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(src)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"g++ failed for {src.name}:\n{proc.stderr}")
            os.replace(tmp, path)
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib


def bind(lib: ctypes.CDLL, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``symbol`` of a loaded library; every entry point
    returns the ``cudaError_t`` of its launch."""
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``symbol`` of kernel library ``name``."""
    return bind(load(name), symbol, argtypes)


def build_variants(name: str, variants: Dict[str, list]) -> Dict[str, ctypes.CDLL]:
    """For the sweeps: one library of kernel ``name`` per variant, each built
    from a copy of ``csrc/`` edited by the variant's ``(file, old, new)``
    replacements, into ``_build/sweep/<name>/<variant>/``; every ``nvcc``
    runs at once. Prints, as a JSON line, each variant's ``ptxas`` warnings
    and how many of its functions spill.
    Raises if an edit does not apply or a build fails."""
    procs = {}
    for variant, edits in variants.items():
        src = BUILD_DIR / "sweep" / name / variant
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(CSRC, src)
        for fname, old, new in edits:
            path = src / fname
            text = path.read_text()
            if old not in text:
                raise ValueError(f"{variant}: {fname} has no {old!r}")
            path.write_text(text.replace(old, new))
        procs[variant] = (src, start_nvcc(src / f"{name}.cu", src / "lib.so"))
    libs = {}
    for variant, (src, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {variant}:\n{log}")
        warnings = [line for line in log.splitlines() if "warning" in line]
        spills = [m for m in re.findall(r"(\d+) bytes spill stores", log) if int(m)]
        print(json.dumps({"variant": variant, "ptxas_warnings": warnings[:5],
                          "spilling_functions": len(spills)}), flush=True)
        libs[variant] = ctypes.CDLL(str(src / "lib.so"))
    return libs


def ptr(t) -> ctypes.c_void_p:
    """Device address of tensor ``t`` (null for None)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def on(device):
    """Make ``device`` (a CUDA device or its index) the current one for a
    launch or a plan: the kernels read the current device's SM count and
    set their attributes per device, and launch on its current stream."""
    return torch.cuda.device(device)


def stream() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream, on which every kernel launches."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
