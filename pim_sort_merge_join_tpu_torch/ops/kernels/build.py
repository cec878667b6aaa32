"""Build the CUDA kernels at first use, load them with ctypes, and count
their launches: the one seam between the kernel modules and their callers.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` call, all started
together, and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds). The library's
file name carries a hash of the sources and flags,
so a stale build is never loaded; it is written under a temporary name and
moved into place, so no reader sees a partial file. The check and the
build hold a lock across processes (`utils/build_lock.py`), so ranks that
reach first use together build once and the others load that library.

Each kernel module declares its C entry points with their argument types,
the check that the library was built with the sizes the module plans for,
and the kernels it launches (`declare`); it calls an entry point through
`entry` and counts each launch through `launched`. `engine/metrics` reads
`launches` at each stage, and sets `counter` to its own `count`, which
receives what the sorts pass to `count`: the elements and passes they take.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable

import torch

from pim_sort_merge_join_tpu_torch.utils.build_lock import build_lock

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# Each declared entry point's argument types and its module's check; the
# entry points looked up; the checks that passed.
_declared: dict[str, tuple[list, Callable[[], None] | None]] = {}
_entries: dict[str, ctypes._CFuncPtr] = {}
_passed: set = set()

# Launches since the last `ops/kernels.reset_launch_counts`, by kernel,
# and their total.
launch_counts: dict[str, int] = {}
launches = 0
# Where `count` sends a sort's work; `engine/metrics` sets it.
counter: Callable[..., None] | None = None


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsmj_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if no library for the current sources exists."""
    path = library_path()
    if path.exists():
        return path
    with build_lock(BUILD_DIR):
        if not path.exists():  # another process may have built it meanwhile
            _compile(path)
    return path


def _compile(path: Path) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objects = [os.path.join(objdir, src.stem + ".o") for src in sources()]
        cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for src, obj in zip(sources(), objects)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
        results = [(cmd, proc.communicate(), proc.returncode) for cmd, proc in zip(cmds, procs)]
        link = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *objects]
        if all(rc == 0 for _, _, rc in results):
            linked = subprocess.run(link, capture_output=True, text=True)
            results.append((link, (linked.stdout, linked.stderr), linked.returncode))
    for cmd, (_, stderr), rc in results:
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{stderr}")
    os.replace(tmp, path)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


def c_function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """A C entry point of the library; every entry returns its cudaError_t."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def declare(argtypes: dict[str, list], kernels: tuple[str, ...],
            check: Callable[[], None] | None = None) -> None:
    """A kernel module's C entry points (name: argument types), the
    kernels whose launches it counts, and ``check``, which raises unless the
    library was built with the sizes the module plans for; it runs before
    the first of the module's entry points is looked up."""
    for name, types in argtypes.items():
        _declared[name] = (types, check)
    for kernel in kernels:
        launch_counts.setdefault(kernel, 0)


def entry(name: str) -> ctypes._CFuncPtr:
    """The declared C entry point ``name``, looked up once."""
    fn = _entries.get(name)
    if fn is None:
        argtypes, module_check = _declared[name]
        if module_check is not None and module_check not in _passed:
            module_check()
            _passed.add(module_check)
        fn = _entries[name] = c_function(name, argtypes)
    return fn


def launched(kernel: str, n: int = 1) -> None:
    """Count ``n`` launches of ``kernel``."""
    global launches
    launch_counts[kernel] += n
    launches += n


def count(**counts: int) -> None:
    """Count a sort's work (``elements``, ``passes``) through `counter`,
    which adds it to the innermost open stage of the running query."""
    if counter is not None:
        counter(**counts)


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors must share one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
