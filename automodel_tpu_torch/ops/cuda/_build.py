"""Build `csrc/*.cu` into shared libraries with nvcc and load them with ctypes.

Each source compiles on its own into `csrc/build/<stem>-<hash>.so` (a
directory git ignores), keyed by a hash of the source text, the local
headers it includes and the flags, so an edited source or header rebuilds
and an unchanged one is reused. The libraries have
a plain C interface: no PyTorch headers, so a build takes seconds. ptxas's
resource report (registers, shared memory, spills) is kept beside each
library as `<stem>-<hash>.log`. Each library's C dispatch counts the
launches of each device kernel it issues; `read_counts` reads them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise FileNotFoundError("nvcc not found (set CUDA_HOME)")
    return found


def library_path(source: str) -> Path:
    """Where `source` (a file name under csrc/) builds to: keyed by its
    text, the local headers it includes and the flags."""
    text = (CSRC / source).read_bytes()
    headers = re.findall(rb'#include "([\w.]+)"', text)
    digest = hashlib.sha256(
        text + b"".join((CSRC / h.decode()).read_bytes() for h in headers)
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(*sources: str) -> list[Path]:
    """Compile every source not built yet, all nvcc processes started
    together; returns the library paths. Raises with nvcc's output when a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = [library_path(s) for s in sources]
    procs = []
    for src, out in zip(sources, outs):
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return outs


def load_library(source: str) -> ctypes.CDLL:
    """The ctypes handle of `source`'s library, building it on first use."""
    lib = _loaded.get(source)
    if lib is None:
        (path,) = build(source)
        lib = _loaded[source] = ctypes.CDLL(str(path))
    return lib


def read_counts(fn) -> list[int]:
    """The launch counters of a library's `<prefix>_launch_counts(out, n)`
    (which writes the first n into out and returns how many there are)."""
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
    fn.restype = ctypes.c_int
    n = fn(None, 0)
    out = (ctypes.c_longlong * n)()
    fn(out, n)
    return list(out)
