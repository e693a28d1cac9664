"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded through ``ctypes``.
Libraries are built on first use into ``build/kernels/`` at the root of
the checkout, named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edit rebuilds and an unchanged
source loads the earlier build. Nothing is
built when a module is imported: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterable

from ..utils import trace

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# Every kernel source of the port, csrc/<name>.cu: K1, K2, K3, K4 (from a
# saved pre, and recomputing it), the node-MLP route's node update and node
# backward, K5, K6, K7, K8 (ops/segment_kernels.py, ops/fused_kernels.py)
KERNELS = (
    "sender_gather", "sender_scatter", "fused_edge", "fused_node", "fused_edge_bwd",
    "fused_edge_bwd_recompute", "fused_node_bwd", "segment_sum", "receiver_expand",
    "fused_edge_v2", "fused_edge_v2_bwd",
)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_built: set[str] = set()  # built by nvcc in this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "CUDA kernels are built on first use on a machine with the CUDA "
        "toolkit"
    )


def library_path(name: str) -> Path:
    digest = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for source in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(source.read_bytes())
    digest = digest.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str):
    """Start ``nvcc`` for one source: ``(name, tmp_path, process)``, or
    None when the library is already built."""
    lib = library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return name, tmp, proc


def _finish_build(name: str, tmp: Path, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    lib = library_path(name)
    lib.with_suffix(".log").write_text(log or "", encoding="utf-8")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{log}"
        )
    os.replace(tmp, lib)


def build(names: Iterable[str] = KERNELS) -> None:
    """Build the named kernels (all of them by default), one ``nvcc`` per
    source, all at once: the span ``kernel_build.nvcc`` and a count
    ``kernel_build.built.<name>`` each (``utils.trace``)."""
    with _lock:
        started = [b for b in (_start_build(n) for n in names) if b]
        if not started:
            return
        errors = []
        with trace.span("kernel_build.nvcc"):
            for job in started:
                try:
                    _finish_build(*job)
                    _built.add(job[0])
                    trace.count(f"kernel_build.built.{job[0]}")
                except RuntimeError as e:
                    errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def build_log(name: str) -> str:
    """The compiler's output for the current build of ``name`` (the
    ``-Xptxas -v`` register and shared-memory report)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text(encoding="utf-8") if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                _loaded[name] = lib
                if name not in _built:  # an earlier process built it
                    trace.count(f"kernel_build.loaded.{name}")
    return lib
