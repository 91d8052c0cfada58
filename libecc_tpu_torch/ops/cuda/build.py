"""Build and load the port's CUDA kernels.

Every ``libecc_tpu_torch/csrc/*.cu`` file is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``; no PyTorch headers are involved, so a build takes seconds. The
sources are compiled in parallel, one ``nvcc`` each, at the first use of
any kernel. The libraries go into ``libecc_tpu_torch/_build/`` (listed in
``.gitignore``) under a name that carries a hash of the sources and flags,
so an edited source is rebuilt and an unchanged one is reused.
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

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# groupfield.cuh's shape tables (GroupShape: kernels 4, 6, 7 and 6-ed;
# AddShape: kernels 2, 3, 8a and 8b): a table's default line and each
# K's own
SHAPES_HEADER = "groupfield.cuh"
SHAPE_RE = re.compile(r"struct (\w+Shape)(?:<(\d+)>)? : "
                      r"Shape<(\d+), (\d+), (true|false)>")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# source stem -> nvcc output of the last build (ptxas register/spill lines)
build_log: dict[str, str] = {}
# source stem -> seconds from the start of the build to its nvcc's end
build_file_seconds: dict[str, float] = {}
build_seconds: float | None = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _tag() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _build_all() -> None:
    global build_seconds
    sources = sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(exist_ok=True)
    tag = _tag()
    outs = {s.stem: BUILD_DIR / f"{s.stem}-{tag}.so" for s in sources}
    todo = [s for s in sources if not outs[s.stem].exists()]
    t0 = time.perf_counter()
    if todo:
        nvcc = nvcc_path()
        procs = []
        try:
            for src in todo:
                tmp = outs[src.stem].with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
                procs.append((src.stem, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            logs = {}

            def wait(stem, proc):
                logs[stem] = proc.communicate()[0]
                build_file_seconds[stem] = time.perf_counter() - t0

            waiters = [threading.Thread(target=wait, args=(stem, proc))
                       for stem, _, proc in procs]
            for th in waiters:
                th.start()
            for th in waiters:
                th.join()
            failed = []
            for stem, tmp, proc in procs:
                build_log[stem] = logs[stem]
                if proc.returncode != 0:
                    failed.append(f"{stem}.cu:\n{logs[stem]}")
                else:
                    os.replace(tmp, outs[stem])
            if failed:
                raise RuntimeError("nvcc failed for " + "\n".join(failed))
        finally:
            for _, tmp, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if tmp.exists():
                    tmp.unlink()
    build_seconds = time.perf_counter() - t0
    for stem, path in outs.items():
        _LIBS[stem] = ctypes.CDLL(str(path))


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (building all
    kernels on first use)."""
    with _LOCK:
        if not _LIBS:
            _build_all()
        return _LIBS[name]


def kernel_name(base: str, k: int) -> str:
    """A kernel's name in the launch counts and reports: the K = 8 instance
    keeps the base name, any other carries its limb count ("mont_mul",
    "mont_mul_k6", "mont_mul_k14")."""
    return base if k == 8 else f"{base}_k{k}"


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def shapes_of(text: str) -> dict:
    """Table -> {K (None: the table's default) -> "t{TPI}x{threads}", with
    "i" where the products are inlined}, from the shape lines of
    groupfield.cuh's text."""
    out = {}
    for table, k, t, b, i in SHAPE_RE.findall(text):
        out.setdefault(table, {})[int(k) if k else None] = (
            f"t{t}x{b}" + ("i" if i == "true" else ""))
    return out


def shape_at(shapes: dict, table: str, k: int) -> str:
    """The shape of a table at K in shapes_of's result."""
    rows = shapes[table]
    return rows.get(k, rows.get(None))


def shape(table: str, k: int) -> str:
    """The shape that the sources set for a kernel family at K."""
    return shape_at(shapes_of((CSRC / SHAPES_HEADER).read_text()), table, k)
