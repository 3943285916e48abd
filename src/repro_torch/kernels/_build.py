"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface, all sources at once in parallel,
and loaded with `ctypes`.  The libraries go to `build/repro_torch_kernels/
<hash>/` at the root of the checkout, keyed by a hash of the sources and
flags, so a library is built once per source version.  A failed build
raises: there is no fallback.

`build()` is thread-safe: the serving frontend's dispatch and resolve
threads may both reach a kernel first.  The `launches` counters of the
wrappers are plain integers bumped without a lock; they are read only
around single-threaded windows.
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
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# per library: ptxas reports each dual_x and proj kernel instance's
# registers and spills (read by chip_smoke.py), and nvcc optimizes
# dual_x's many kernel instances in parallel (otherwise the slowest build
# by twice)
EXTRA_FLAGS = {"dual_x": ("-Xptxas", "-v", "--split-compile=0"),
               "proj": ("-Xptxas", "-v")}

_vp = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
_vpp = ctypes.POINTER(ctypes.c_void_p)   # an array of pointers, one a bucket
_ip = ctypes.POINTER(ctypes.c_int)
# the Ax kernels' work table, output, scratch, J and stream
_TABLE = [_vp, _vp, _i, _vp, _i, _vp, _vp, _i, _vp]

# argtypes/restype of every C entry point, per library
SIGNATURES = {
    "dual_x": {   # K1 dual_x and K3 dual_grad
        "dual_x_scratch": ([_ll, _i, _i, _i], _ll),
        "dual_x_launch": ([_i] + [_vp] * 12 + [_ll] + [_i] * 7 + [_vp], _i),
        "dual_grad_launch": ([_i] + [_vp] * 13 + [_ll] + [_i] * 7 + [_vp],
                             _i),
    },
    "ax_reduce_x": {   # K2
        "ax_reduce_x_max_families": ([], _i),
        "ax_reduce_x_max_buckets": ([], _i),
        "ax_reduce_x_launch": ([_i, _i, _vp, _i, _vpp, _vpp, _vpp, _ip]
                               + _TABLE, _i),
    },
    "ax_reduce": {   # K4
        "ax_reduce_max_families": ([], _i),
        "ax_reduce_max_buckets": ([], _i),
        "ax_reduce_launch": ([_i, _i, _vp, _i, _vpp, _vpp, _ip] + _TABLE,
                             _i),
    },
    "proj": {   # K5
        "proj_scratch": ([_ll, _i, _i, _i], _ll),
        "proj_launch": ([_i] + [_vp] * 6 + [_ll] + [_i] * 5 + [_vp], _i),
    },
}


class _State:
    libs: Optional[Dict[str, ctypes.CDLL]] = None
    build_seconds: float = 0.0
    build_log: str = ""
    # one build at a time: two threads would both spawn nvcc onto the
    # same per-process temporary names
    lock = threading.Lock()


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump) next to nvcc."""
    return str(Path(_nvcc()).with_name(name))


def library_path(name: str) -> Path:
    """Where `build()` puts the library of `csrc/<name>.cu`."""
    return BUILD_ROOT / _source_hash() / f"lib{name}.so"


def _nvcc() -> str:
    cand = [shutil.which("nvcc")]
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cand.append(os.path.join(home, "bin", "nvcc"))
    cand.append("/usr/local/cuda/bin/nvcc")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit's nvcc (set CUDA_HOME)")


def _source_hash() -> str:
    h = hashlib.sha256(repr((NVCC_FLAGS, EXTRA_FLAGS)).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library; returns
    {source name: CDLL}.  Raises RuntimeError on a failed build."""
    if _State.libs is not None:     # the fast path takes no lock
        return _State.libs
    with _State.lock:
        if _State.libs is None:
            _State.libs = _build_locked()
    return _State.libs


def _build_locked() -> Dict[str, ctypes.CDLL]:
    out_dir = BUILD_ROOT / _source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in SIGNATURES:
        lib = out_dir / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()),
               "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    logs, failed = [], []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs.append(f"== nvcc {name}.cu (rc={proc.returncode}, done after "
                    f"{time.perf_counter() - t0:.1f} s)\n{out}")
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, lib)
    _State.build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{_State.build_log}")
    libs = {}
    for name, sigs in SIGNATURES.items():
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        for fn, (argtypes, restype) in sigs.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        libs[name] = lib
    _State.build_seconds = time.perf_counter() - t0
    return libs


def build_seconds() -> float:
    return _State.build_seconds


def build_log() -> str:
    """nvcc's output of this process's builds (ptxas register/spill lines
    of the libraries built with `-Xptxas -v`)."""
    return _State.build_log


def check_tensor(fn: str, name: str, t, shape, dtype, device) -> None:
    """Raise unless `t` has the shape, dtype and device a kernel takes and
    is contiguous (the kernels index raw pointers)."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} is {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _vec_bytes(nbytes: int) -> int:
    """The width of the kernels' vector loads of a chunk of `nbytes`
    bytes (common.cuh `vec_bytes`)."""
    return next(b for b in (16, 8, 4, 2, 1) if nbytes % b == 0)


def check_aligned(fn: str, tensors, w: int, m: int, vals: int) -> None:
    """Raise unless every pointer that a kernel's vector loads and stores
    touch is aligned to their width.  They move `vals` values of a row at
    a time and run when w is a multiple of `vals`; a and gvals
    (`a_vals`, `gvals`, m values an entry) take them for m <= 2 only.
    `tensors` maps names to tensors (None: not passed)."""
    if w % vals:
        return
    for name, t in tensors.items():
        per_entry = m if name in ("a_vals", "gvals") else 1
        if t is None or per_entry > 2:
            continue
        nb = _vec_bytes(vals * per_entry * t.element_size())
        if t.data_ptr() % nb:
            raise ValueError(
                f"{fn}: {name} must be {nb}-byte aligned for the kernel's "
                f"vector loads (address {t.data_ptr():#x})")


def check(rc: int, what: str) -> None:
    """Raise on a non-zero return code of a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: "
                           + ("shape not supported by the kernel" if rc == -1
                              else f"CUDA error {rc}"))
