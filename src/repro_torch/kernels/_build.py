"""Build the CUDA sources under ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled on first use, by ``nvcc`` alone, into
``build/lib<name>-<hash>.so`` beside this file (the directory is listed
in ``.gitignore``)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

``-Xptxas -v`` makes ``ptxas`` report each kernel's registers, spills
and static shared memory; the report is kept beside the library as
``build/lib<name>-<hash>.log`` (:func:`ptxas_report`).

The sources expose a plain C interface (no PyTorch headers), so a build
takes seconds.  ``<hash>`` covers the source text, the shared headers
(``csrc/*.cuh``) and the flags: an edited source or header gets a new
library and a stale one is never loaded.  Each
C entry returns ``cudaGetLastError()`` after its launch; :func:`check`
raises on a non-zero code.

Nothing here runs at import time: the CPU tests import every module on a
host without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    the first ``nvcc`` on ``PATH``."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built on the machine with the card")
    return found


def library_path(name: str, defines: tuple = ()) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by source, headers and
    flags (``defines``: nvcc ``-D`` flags added to :data:`NVCC_FLAGS`)."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join((*NVCC_FLAGS, *defines)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


@functools.cache
def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed
    (with the nvcc ``defines`` added, a library of its own: the tests
    build variants of a kernel this way).

    ``nvcc`` writes to a temporary name that is renamed into place only
    when complete, so several sources may be built at once from threads
    (``nvcc`` runs outside the GIL)."""
    out = library_path(name, defines)
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *defines, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for "
                               f"{out.name}:\n{proc.stdout}")
        out.with_suffix(".log").write_text(proc.stdout)
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def ptxas_report(name: str) -> dict:
    """``{kernel: {"registers", "spill_stores", "spill_loads", "smem"}}``
    from the ``ptxas -v`` report of ``csrc/<name>.cu``'s last build here
    (mangled kernel names; empty if the report is missing)."""
    log = library_path(name).with_suffix(".log")
    if not log.is_file():
        return {}
    report, kernel = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            kernel = m.group(1)
            report.setdefault(kernel, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and kernel:
            report[kernel].update(spill_stores=int(m.group(1)),
                                  spill_loads=int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            report[kernel]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            report[kernel]["smem"] = int(sm.group(1)) if sm else 0
            kernel = None
    return report


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (``cudaGetLastError``).

    Every source exports ``error_string(int)`` (``cudaGetErrorString``)."""
    if code != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        msg = lib.error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} at launch: {msg}")
