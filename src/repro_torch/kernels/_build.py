"""Build and bind the port's CUDA kernels (`src/repro_torch/csrc/*.cu`).

Every source is compiled by `nvcc` for Hopper (`sm_90a`), one process per
file, all started together, and linked into one shared library with a plain
C interface that `ctypes` loads. The library is built at first use into
`build/repro_torch/` at the root of the checkout (listed in `.gitignore`),
named by a hash of the sources and flags, so a changed source rebuilds and
an unchanged one is loaded as it is. `-Xptxas -v` output (registers, shared
memory, spills of every kernel) is printed to stderr once, when it builds.

Each C entry launches on the stream it is given and returns
`cudaGetLastError()`; `launch` raises if that is not 0.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of every C entry; the stream (last) is a pointer too
SIGNATURES = {
    "pq_score_probes_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P),
    "pq_score_probes_select_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _I, _I, _P, _P, _P, _P),
    "assign_prepare_launch": (_P, _I, _I, _P, _P, _P),
    "vq_assign_launch": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    "soar_assign_launch": (_P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _P, _P, _P),
    "lloyd_assign_launch": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    "lloyd_group_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _P, _P, _P, _P, _P, _P, _P, _P, _P),
    "tree_route_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "pq_score_launch": (_P, _P, _I, _I, _I, _P, _P),
    "int8_rerank_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    "kmeans_pp_launch": (_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P, _P, _P, _P, _P, _P),
}


def nvcc() -> str:
    """Path of the CUDA compiler; raises where there is none."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of repro_torch cannot be built on this machine")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libreprotorch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the library unless it exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    compiler = nvcc()
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for f in cu:
            obj = Path(tmp) / (f.stem + ".o")
            cmd = [compiler, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(f),
                   "-o", str(obj)]
            procs.append((f, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for f, _, p in procs:
            log, _ = p.communicate()
            print(f"[nvcc {f.name}]\n{log}", file=sys.stderr, end="")
            if p.returncode != 0:
                failed.append(f.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}")
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [compiler, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, out)      # atomic: concurrent builders agree
    return out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare argtypes/restype of every C entry of `lib`."""
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    return bind(ctypes.CDLL(str(build())))


@functools.cache
def entry(name: str):
    """The bound C entry `name` of the kernel library, looked up once."""
    return getattr(library(), name)


def launch(name: str, *args) -> None:
    """Call C entry `name` on the current stream of the device its tensors
    lie on; tensors pass as pointers.

    Raises if the launch was refused (the entry's cudaGetLastError()).
    """
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    fn = entry(name)
    if device.index == torch.cuda.current_device():
        # the raw handle of torch.cuda.current_stream(), without building
        # a Stream object (a few µs of host time a launch)
        rc = fn(*conv, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            rc = fn(*conv, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU: the plain version's case."""
    return not any(t.is_cuda for t in tensors) and all(
        t.device.type == "cpu" for t in tensors)


def on_meta(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the "meta" device (shapes, no data):
    a dry run's case. A wrapper then returns its output's shape and
    reports its kernel's work (`report`); it never launches."""
    return all(t.device.type == "meta" for t in tensors)


def report(name: str, nbytes: float, flops: float = 0.0) -> None:
    """Tell every active dispatch mode that counts kernel work (one with a
    `kernel_work(name, nbytes, flops)` method, as the dry run's op
    analysis has) what kernel `name` would do: the bytes it must move and
    its product FLOPs. A kernel launched through ctypes is seen by no
    dispatch mode, so its wrapper's meta branch says it here."""
    for mode in _get_current_dispatch_mode_stack():
        work = getattr(mode, "kernel_work", None)
        if work is not None:
            work(name, nbytes, flops)


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one and the same CUDA device (no
    CPU fallback)."""
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) > 1:
        raise ValueError(
            f"kernel inputs must all be CUDA tensors on one device, or all "
            f"CPU tensors; got {[str(x.device) for x in tensors]}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Validate one kernel argument before its pointer is taken."""
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-d {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}"
                         f"{'' if t.is_contiguous() else ' (strided)'}")


def vec4(d: int, *tensors: torch.Tensor) -> int:
    """1 when rows of width d can move as float4: d % 4 == 0 and every
    tensor 16-byte aligned."""
    return int(d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))
