"""Build and load the port's CUDA kernels.

At first use, every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
(one compiler process per source, all started together), and the objects
are linked into one shared library with a plain C interface.  The
library lands in ``build/repro_torch/<hash>/`` at the root of the
checkout, keyed by a hash of the sources and flags, and is loaded with ``ctypes``.  Nothing here runs at
import: the CPU tests import every module with no ``nvcc`` present.
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
from typing import Optional

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = _ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v"]
LIB_NAME = "librepro_torch_kernels.so"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types (pointers and the stream are
# c_void_p, ints c_int, floats c_float); every entry returns the CUDA
# error code of its launch.
SIGNATURES = {
    # q, k, v, o, B, H, Hkv, Sq, Sk, D, dtype, causal, window, softcap,
    # scale, stream
    "repro_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _F, _F, _P],
    # q, k, v, o, part_acc, part_ml, B, H, Hkv, S, D, dtype, kv_begin,
    # kv_len, chunk, n_split, softcap, scale, stream
    "repro_decode_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _F, _F, _P],
    # x, dt, A, Bm, Cm, y, state, cb (C B^T scratch), B, L, H, P, N, chunk,
    # dtype, out_dtype, stream
    "repro_ssd_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_dir: Optional[Path] = None


def build_root() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def _key() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    cus, headers = _sources()
    for p in cus + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> None:
    """Compile every source in parallel, link, and publish ``out_dir``."""
    nvcc = _nvcc()
    cus, _ = _sources()
    root = out_dir.parent
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=root))
    procs = [(src, subprocess.Popen(
        [nvcc, *FLAGS, "-I", str(_CSRC), "-c", str(src),
         "-o", str(tmp / (src.stem + ".o"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in cus]
    log, failed = [], []
    for src, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name} (rc {p.returncode})\n{out}")
        if p.returncode:
            failed.append(src.name)
    if not failed:
        link = subprocess.run(
            [nvcc, *_ARCH, "-shared", *[str(tmp / (s.stem + ".o")) for s in cus],
             "-o", str(tmp / LIB_NAME)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode:
            failed.append("link")
    (tmp / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    try:
        os.replace(tmp, out_dir)
    except OSError:          # another process published the same key first
        shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib, _lib_dir
    with _lock:
        if _lib is None:
            out_dir = build_root() / _key()
            if not (out_dir / LIB_NAME).exists():
                _compile(out_dir)
            lib = ctypes.CDLL(str(out_dir / LIB_NAME))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib, _lib_dir = lib, out_dir
        return _lib


def library_dir() -> Path:
    """The directory of the library that ``library()`` loaded; its
    ``build.log`` holds the compiler's output, with the ``-Xptxas -v``
    register, spill and shared-memory counts."""
    library()
    return _lib_dir


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: the kernel launch returned CUDA "
                           f"error {rc}")
