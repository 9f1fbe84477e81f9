"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). Libraries go to
``build/repro_torch/`` at the checkout root (``REPRO_TORCH_BUILD_DIR``
overrides it, and must be set where the package is installed rather than
run from a checkout), named by a hash of their sources and flags, so an edited
source is rebuilt and an unchanged one never is. The build runs at first
use; ``build_all`` compiles every missing library in parallel, one
``nvcc`` per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

__all__ = ["KERNELS", "build_all", "build_dir", "build_log", "call", "load",
           "nvcc_path", "ptxas_report", "sass"]

CSRC = Path(__file__).resolve().parent / "csrc"

# kernel library -> its source file (every source includes common.cuh)
KERNELS = {
    "verify_grouped": "verify_grouped.cu",
    "probe_walk": "probe_walk.cu",
    "probe_scan": "probe_scan.cu",
    "hamming_scan": "hamming_scan.cu",
    "blockmax_scan": "blockmax_scan.cu",
    "verify_tuples": "verify_tuples.cu",
    "flash_attention": "flash_attention.cu",
}
_HEADERS = ("common.cuh", "sm90.cuh", "topk.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-lineinfo",
)

_P = ctypes.c_void_p
# C entry point and argtypes, per kernel (hamming_scan_topk lives in the
# hamming_scan library, probe_scan_topk in the probe_scan library,
# probe_extract in the probe_walk library)
_ENTRY = {
    "verify_grouped": ("verify_grouped_launch", [_P, _P, _P]),
    "probe_scan": ("probe_scan_launch", [_P, _P, _P]),
    "probe_walk": ("probe_walk_launch", [_P, _P, _P, _P]),
    "probe_scan_topk": ("probe_scan_topk_launch", [_P, _P, _P]),
    "probe_extract": ("probe_extract_launch", [_P, _P, _P]),
    "hamming_scan": ("hamming_scan_launch", [_P, _P, _P]),
    "hamming_scan_topk": ("hamming_scan_topk_launch", [_P, _P, _P]),
    "blockmax_scan": ("blockmax_scan_launch", [_P, _P, _P]),
    "verify_tuples": ("verify_tuples_launch", [_P, _P, _P]),
    "flash_attention": ("flash_attention_launch", [_P, _P, _P]),
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> checkout root
    here = Path(__file__).resolve()
    root = here.parents[3]
    if here.parents[2].name != "src" or not (root / "pyproject.toml").is_file():
        raise RuntimeError(
            "repro_torch is not running from a source checkout: set "
            "REPRO_TORCH_BUILD_DIR to the directory its kernels build into"
        )
    return root / "build" / "repro_torch"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (KERNELS[name],) + _HEADERS:
        h.update((CSRC / f).read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=None) -> Dict[str, float]:
    """Compile every missing library (all ``nvcc`` processes started at
    once). Returns {name: seconds} for the libraries built by this call;
    raises ``RuntimeError`` with the compiler's output on any failure.
    Each build's ``nvcc``/``ptxas`` report is kept next to its library
    (``<lib>.log``)."""
    names = list(KERNELS) if names is None else list(names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = _lib_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / KERNELS[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, target)
    built: Dict[str, float] = {}
    errors = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        target.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {KERNELS[name]}:\n{log}")
            continue
        os.replace(tmp, target)
        built[name] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return built


def build_log(name: str) -> Optional[str]:
    """The compiler's report of the current build of ``name`` (registers,
    shared memory, spills), if this checkout built it."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else None


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """Per kernel function (mangled name) of the current build of ``name``:
    its ``registers``, static ``smem`` bytes and ``spill`` bytes (stores
    plus loads), from the ``ptxas -v`` lines of its build log ({} if this
    checkout did not build it)."""
    out: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in (build_log(name) or "").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {"registers": 0, "smem": 0, "spill": 0})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[fn]["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[fn]["smem"] = int(m.group(1)) if m else 0
    return out


def sass(name: str) -> Optional[str]:
    """The SASS of the current build of ``name`` (``cuobjdump -sass``), or
    None where the toolkit has no ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or str(Path(nvcc_path()).parent /
                                            "cuobjdump")
    if not Path(tool).exists():
        return None
    return subprocess.run([tool, "-sass", str(_lib_path(name))],
                          capture_output=True, text=True, check=True).stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
    return lib


def call(lib: ctypes.CDLL, name: str, ptrs, scalars, stream: int,
         *extra) -> None:
    """Launch kernel ``name`` of ``lib`` with device addresses ``ptrs`` and
    int ``scalars`` on ``stream``; raise if the launch was refused."""
    fn_name, argtypes = _ENTRY[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    p = (ctypes.c_longlong * len(ptrs))(*[int(x) for x in ptrs])
    s = (ctypes.c_int * len(scalars))(*[int(x) for x in scalars])
    rc = fn(p, s, ctypes.c_void_p(stream), *extra)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def require(t, name: str, shape=None, device=None, dtype=None) -> int:
    """Check one kernel operand (contiguous, of ``dtype``, int32 by
    default, ``shape`` where given, on ``device`` where given) and return
    its address."""
    import torch

    dtype = torch.int32 if dtype is None else dtype
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    return t.data_ptr()


def stream_of(device) -> int:
    """The current CUDA stream of ``device`` as an address (0 off-card)."""
    import torch

    if device.type != "cuda":
        return 0
    return torch.cuda.current_stream(device).cuda_stream
