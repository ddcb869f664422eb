"""Build the package's native sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds); each ``csrc/<name>.cpp`` (host code) compiles with ``g++``
the same way. Libraries go under ``csrc/build/``, keyed by a hash of the
source, the flags and, for a ``.cu`` source, every ``csrc/*.cuh`` header:
an edited source or header builds anew, an unchanged one loads the library
already built. ``build_all`` starts one compiler per source,
all at once. Nothing here runs at import time.

One host source differs: ``hnsw_builder.cpp`` keeps the JAX package's
flags, ``-march=native`` (its AVX-512 / AVX2 distance loops; without it
they are scalar) and ``-pthread`` (its build and search thread pools), and
its key also holds the host's vector-ISA fingerprint, so a checkout moved
to a host without those extensions builds anew instead of loading a
library that would fault. ``tsan_harness.cpp`` is a program, not a
library (tests build it with ``-fsanitize=thread``), and is not built
here.

``Kernel`` is one C entry of a CUDA library with the count of its
launches; every ``Kernel`` made registers itself in ``KERNELS``, the one
list of the package's kernels across all sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
#: host code: no -march=native, so a library built on one host runs on any
#: x86-64 host of the same ABI
GXX_FLAGS = (
    "-O3", "-std=c++17", "-shared", "-fPIC", "-funroll-loops", "-fopenmp-simd",
)
#: the host source built for this host's vector ISA, and its extra flags
#: (see the module docstring)
NATIVE_ISA_SOURCE = "hnsw_builder"
NATIVE_ISA_FLAGS = ("-march=native", "-pthread")
#: the source under csrc/ that is a program, not a library
PROGRAM = "tsan_harness"

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: compiler output (ptxas register / spill report) of this process's builds
build_logs: dict[str, str] = {}


def sources() -> list[str]:
    """Names of every native library source under csrc/ (CUDA and host)."""
    return sorted(p.stem for p in (*CSRC.glob("*.cu"), *CSRC.glob("*.cpp"))
                  if p.stem != PROGRAM)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels need the CUDA toolkit "
            "(set CUDA_HOME or put nvcc on PATH)"
        )
    return path


def _gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the host library needs a C++ compiler")
    return path


def _source(name: str) -> Path:
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _flags(name: str) -> tuple:
    if _source(name).suffix == ".cu":
        return NVCC_FLAGS
    return GXX_FLAGS + (NATIVE_ISA_FLAGS if name == NATIVE_ISA_SOURCE else ())


def isa_fingerprint() -> str:
    """The host's vector-ISA flags that ``-march=native`` code may use, as
    the JAX package's native loader stamps them."""
    import platform
    import re

    try:
        text = Path("/proc/cpuinfo").read_text()
        m = re.search(r"^flags\s*:\s*(.*)$", text, re.M)
        if m:
            relevant = {"sse4_2", "avx", "avx2", "fma", "avx512f"}
            flags = sorted(set(m.group(1).split()) & relevant)
            if flags:
                return platform.machine() + ":" + "-".join(flags)
    except OSError:
        pass
    return platform.machine()


def _command(name: str) -> list[str]:
    if _source(name).suffix == ".cu":
        return [_nvcc(), *_flags(name)]
    return [_gxx(), *_flags(name)]


def _target(name: str) -> Path:
    src = _source(name)
    digest = hashlib.sha256(src.read_bytes())
    if src.suffix == ".cu":
        for header in sorted(CSRC.glob("*.cuh")):
            digest.update(header.read_bytes())
    digest.update(" ".join(_flags(name)).encode())
    if name == NATIVE_ISA_SOURCE:
        digest.update(isa_fingerprint().encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start the compiler for ``name`` unless its library exists; returns
    (process or None, temporary output, final output)."""
    out = _target(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    src = _source(name)
    proc = subprocess.Popen(
        [*_command(name), "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"build failed for csrc/{_source(name).name}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or none


def build_all(names) -> None:
    """Compile every named source in parallel (one compiler each)."""
    started = [(n, *_start(n)) for n in names]
    for n, proc, tmp, out in started:
        _finish(n, proc, tmp, out)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``.cpp``, built on
    first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            proc, tmp, out = _start(name)
            _finish(name, proc, tmp, out)
            lib = _libs[name] = ctypes.CDLL(str(out))
        return lib


class Kernel:
    """One C entry of ``csrc/<library>.cu`` and the count of its launches.
    The entry returns the CUDA error of its launch (0 when none)."""

    def __init__(self, library: str, symbol: str, argtypes: list):
        self.library = library
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        KERNELS.append(self)

    @property
    def source(self) -> str:
        return f"vectorlite_tpu_torch/csrc/{self.library}.cu"

    def launch(self, *args) -> None:
        fn = getattr(load(self.library), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        self.launches += 1


#: every kernel of the package, in the order its modules made them
KERNELS: list[Kernel] = []


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0


def device_kernel_names() -> set[str]:
    """The ``__global__`` functions of every ``csrc`` source: the names
    a profiler trace gives the package's kernels on the card."""
    import re

    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)")
    return {name for path in (*CSRC.glob("*.cu"), *CSRC.glob("*.cuh"))
            for name in pattern.findall(path.read_text())}


def ptxas_report(name: str) -> list[str]:
    """ptxas's register, shared-memory and spill lines for the kernels of
    ``csrc/<name>``, each after the line naming its entry, from this
    process's build (empty for a library already built)."""
    keep = ("Compiling entry", "registers", "spill")
    return [line.strip() for line in build_logs.get(name, "").splitlines()
            if any(k in line for k in keep) and "C7519" not in line]


def main() -> int:
    """``python3 -m vectorlite_tpu_torch.kernels._build``: build every
    native source (on a machine with nvcc) and print ptxas's report of each
    kernel built; exits 1 if a build failed."""
    names = sources()
    started = [(n, *_start(n)) for n in names]
    failed = 0
    for name, proc, tmp, out in started:
        try:
            _finish(name, proc, tmp, out)
        except RuntimeError as e:
            failed += 1
            print(e)
        for line in ptxas_report(name):
            print(f"{name}: {line}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
