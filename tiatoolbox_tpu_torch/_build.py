"""Build the port's CUDA kernels and host C++ and load them with ctypes.

Each source under ``csrc/`` exposes a C interface, so the build needs
neither PyTorch's headers nor ``torch.utils.cpp_extension``: one ``nvcc``
call per CUDA source (``*.cu``) and one ``g++`` call per host source
(``*.cpp``) compiles in seconds. Libraries go to ``<repo>/build_torch/``,
named by a hash of the source, every ``csrc/*.cuh`` and ``csrc/*.h``
header and the compiler's flags, and are built at first use. Beside each CUDA library a
``.ptxas`` file keeps what ``ptxas -v`` said of its kernels (registers,
spills, shared memory). A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build_torch"

NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

# -pthread: the JPEG decoder's batch entry runs std::thread workers
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-pthread")

_load_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# seconds each compiler process of this process took, by source
compile_seconds: dict[str, float] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = cuda_home / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    msg = "nvcc not found on PATH, under CUDA_HOME or in /usr/local/cuda/bin."
    raise RuntimeError(msg)


def find_gxx() -> str:
    """Path of the host C++ compiler ``g++`` on ``PATH``."""
    found = shutil.which("g++")
    if not found:
        msg = "g++ not found on PATH; it builds the port's host C++ (csrc/*.cpp)."
        raise RuntimeError(msg)
    return found


def _is_host(source: str) -> bool:
    return source.endswith(".cpp")


def _flags(source: str) -> tuple[str, ...]:
    return HOST_FLAGS if _is_host(source) else NVCC_FLAGS


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted([*CSRC_DIR.glob("*.cuh"), *CSRC_DIR.glob("*.h")]):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(_flags(source)).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` into a shared library unless it is built.

    Raises:
        RuntimeError: the compiler (``nvcc``, or ``g++`` for a ``.cpp``) is
            missing or fails (the message carries its stderr), or the build
            directory cannot be written.
    """
    out = library_path(source)
    if out.exists():
        return out
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    except OSError as exc:
        msg = f"Cannot create the kernel build directory {BUILD_DIR}: {exc}"
        raise RuntimeError(msg) from exc
    if not os.access(BUILD_DIR, os.W_OK):
        msg = f"The kernel build directory {BUILD_DIR} is not writable."
        raise RuntimeError(msg)
    # Write under private names, then rename, the library last: concurrent
    # builds of the same source never see a half-written library, and a
    # library always has its ptxas report beside it.
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    compiler = find_gxx() if _is_host(source) else find_nvcc()
    cmd = [compiler, *_flags(source), "-o", str(tmp), str(CSRC_DIR / source)]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    compile_seconds[source] = time.perf_counter() - start
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        msg = (
            f"{Path(compiler).name} failed to build {source} "
            f"(exit {proc.returncode}):\n{proc.stderr}"
        )
        raise RuntimeError(msg)
    report = [
        line.strip()
        for line in proc.stderr.splitlines()
        if "Compiling entry function" in line or "registers" in line or "spill" in line
    ]
    tmp_report = tmp.with_suffix(".ptxas")
    tmp_report.write_text("".join(f"{line}\n" for line in report))
    os.replace(tmp_report, out.with_suffix(".ptxas"))
    os.replace(tmp, out)
    return out


def ptxas_report(source: str) -> list[str]:
    """``ptxas -v``'s lines for the built library of ``csrc/<source>`` (none for host C++)."""
    return build(source).with_suffix(".ptxas").read_text().splitlines()


def build_all() -> dict[str, Path]:
    """Build every ``csrc/*.cu`` and ``csrc/*.cpp``, one compiler process per
    source, all started together."""
    names = [p.name for p in sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cpp")])]
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<source>``, once per process."""
    with _load_lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _loaded[source] = lib
        return lib
