"""Build-at-first-use loader for the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), all sources in parallel, and loaded with `ctypes`. The build
directory, ``build/repro_torch_kernels/<hash>/`` under the repository
root, is keyed on a hash of every file in ``csrc/`` and of the compiler
flags, so an edited source rebuilds and an unchanged tree reuses the
libraries. Nothing is built or imported at module import time: the
first kernel launch calls `library`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_ROOT = REPO_ROOT / "build" / "repro_torch_kernels"
SOURCES = ("enqueue", "threshold_step", "due_dedup", "descent",
           "majority_step", "threshold_gate", "rglru", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_INFO: Dict[str, object] = {}  # dir, seconds, ptxas report


def _nvcc() -> str:
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for home in cands:
        exe = Path(home) / "bin" / "nvcc" if home else None
        if exe is not None and exe.is_file():
            return str(exe)
    exe = shutil.which("nvcc")
    if exe is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the port's "
            "CUDA kernels are built from source on first use")
    return exe


def compile_source(name: str, lib: Path, csrc: Path = CSRC,
                   nvcc: str = None) -> subprocess.Popen:
    """Start nvcc on ``csrc/<name>.cu`` into the shared library `lib`,
    with the port's flags; its output (the ptxas report) on stdout."""
    cmd = [nvcc or _nvcc(), *NVCC_FLAGS, "-I", str(csrc), "-o", str(lib),
           str(csrc / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def build_all() -> Path:
    """Compile every missing library (one nvcc per source, all at once).
    Raises RuntimeError with the compiler output if any build fails. Each
    library's compiler report (ptxas registers, spills) is kept beside it
    and read back into BUILD_INFO when the library is reused."""
    out = build_dir()
    todo = [s for s in SOURCES if not (out / f"lib{s}.so").is_file()]
    if not todo:
        BUILD_INFO.setdefault("dir", str(out))
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("ptxas", _reports(out))
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for s in todo:
        tmp = out / f"lib{s}.so.tmp{os.getpid()}"
        procs[s] = (tmp, compile_source(s, tmp, nvcc=nvcc))
    failed, report = [], {}
    for s, (tmp, p) in procs.items():
        log, _ = p.communicate()
        report[s] = log
        if p.returncode != 0:
            failed.append(s)
        else:
            (out / f"lib{s}.ptxas.txt").write_text(log)
            os.replace(tmp, out / f"lib{s}.so")
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(report[s] for s in failed))
    BUILD_INFO.update(dir=str(out), seconds=time.perf_counter() - t0,
                      ptxas=_reports(out))
    return out


def _reports(out: Path) -> Dict[str, str]:
    """The compiler report kept beside each built library in `out`."""
    return {s: (out / f"lib{s}.ptxas.txt").read_text() for s in SOURCES
            if (out / f"lib{s}.ptxas.txt").is_file()}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built if needed)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
            _LIBS[name] = lib
        return lib
