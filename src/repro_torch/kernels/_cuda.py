"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

Each ``.cu`` source is compiled by its own ``nvcc`` (all started together)
into a shared library with a plain C interface, and loaded with ``ctypes``.
The build runs at the first CUDA launch, never at import: importing the
package needs no ``nvcc``.  Libraries go to ``build/repro_torch_kernels/
<hash>/`` at the root of the checkout, keyed by a hash of the sources and
flags, so an edit rebuilds and an unchanged tree reuses the last build.

Launch counts: every wrapper that launches a kernel adds one to its entry
in :data:`LAUNCHES`, where it launches and nowhere else; a run reads the
counts to show that its path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("tile_matvec.cu", "tile_matvec_f32.cu", "tile_tangent.cu",
           "tile_tangent_f32.cu", "tile_jvp.cu", "tile_jvp_f32.cu",
           "tile_matrix.cu", "ski_gram.cu", "ski_tangent.cu",
           "ski_bank.cu", "tile_matvec_nd.cu", "tile_matvec_nd_f32.cu",
           "tile_tangent_nd.cu", "ski_gram_2d.cu", "ski_tangent_2d.cu")
HEADERS = ("tile_fns.cuh", "tile_sweep.cuh", "value_sweep.cuh",
           "tangent_sweep.cuh", "tile_sweep_nd.cuh", "ski_fft.cuh",
           "ski_fft_2d.cuh", "ski_lines_2d.cuh", "ski_lines_1d.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"

KIND_IDS = {"k1": 0, "k2": 1, "se": 2, "matern12": 3, "matern32": 4,
            "matern52": 5}

# kernel name -> launches since the last reset
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_DOUBLE = ctypes.c_double
_SIGNATURES = {
    "tile_matvec_max_cols": [_INT],
    "tile_tangent_rows": [_INT, _INT],
    # the sweeps (B1/B12, B2, B3, B8/B13, B9): (lead..., x1, n1, x2, n2,
    # v, ldv, b, seg_cols, segs, part, out, ldo, stream), lead = (kind,
    # params[, pdots, m]) in 1-D (B3: pdot with m = 1) and (d, kinds_code,
    # params[, pdots, m])
    "tile_matvec_f64": [_INT, _VOID, _VOID, _INT, _VOID, _INT, _VOID, _INT,
                        _INT, _INT, _INT, _VOID, _VOID, _INT, _VOID],
    "tile_tangent_f64": [_INT, _VOID, _VOID, _INT, _VOID, _INT, _VOID, _INT,
                         _VOID, _INT, _INT, _INT, _INT, _VOID, _VOID, _INT,
                         _VOID],
    "tile_jvp_f64": [_INT, _VOID, _VOID, _INT, _VOID, _INT, _VOID, _INT,
                     _VOID, _INT, _INT, _INT, _INT, _VOID, _VOID, _INT,
                     _VOID],
    "tile_matrix_f64": [_INT, _VOID, _VOID, _INT, _VOID, _INT, _VOID, _VOID],
    "tile_nd_max_cols": [_INT, _INT, _INT],
    "tile_matvec_nd_f64": [_INT, _INT, _VOID, _VOID, _INT, _VOID, _INT,
                           _VOID, _INT, _INT, _INT, _INT, _VOID, _VOID, _INT,
                           _VOID],
    "tile_tangent_nd_f64": [_INT, _INT, _VOID, _VOID, _INT, _VOID, _INT,
                            _VOID, _INT, _VOID, _INT, _INT, _INT, _INT,
                            _VOID, _VOID, _INT, _VOID],
}
# B6: (n, m, L, d0, s, occ, wcell, cell, lams, m_dirs, noise2, v, B, c,
# out, scratch0, scratch1, stream)
_SIGNATURES["ski_tangent_f64"] = ([_INT] * 5 + [_VOID] * 4
                                  + [_INT, _DOUBLE, _VOID, _INT, _INT]
                                  + [_VOID] * 4)
# B5 and B7: (n, m, L, s, offs, occ, wcell, cell, lams, noise2, v, B, c,
# out, scratch, L1, col_tpl, col_lpb, row_tpl, row_lpb, stream)
for _name in ("ski_gram_f64", "ski_bank_f64"):
    _SIGNATURES[_name] = ([_INT] * 4 + [_VOID] * 5
                          + [_DOUBLE, _VOID, _INT, _INT, _VOID, _VOID]
                          + [_INT] * 5 + [_VOID])
# B11: (n, m1, m2, L1, L2, s, offs, occ, wcell, cell, lam1, lam2, m_dirs,
# noise2, v, c, out, scratch0, scratch1, stream); B10 the same without
# m_dirs and with its line plan (cap, row_tpl, row_lpb, col_tpl, col_lpb)
# before the stream
_SIGNATURES["ski_tangent_2d_f64"] = ([_INT] * 6 + [_VOID] * 6
                                     + [_INT, _DOUBLE, _VOID, _INT]
                                     + [_VOID] * 4)
_SIGNATURES["ski_gram_2d_f64"] = ([_INT] * 6 + [_VOID] * 6
                                  + [_DOUBLE, _VOID, _INT] + [_VOID] * 3
                                  + [_INT] * 5 + [_VOID])
_SIGNATURES["ski_gram_2d_line_cap"] = [_INT]
for _name in list(_SIGNATURES):
    if _name.endswith("_f64"):
        _SIGNATURES[_name[:-4] + "_f32"] = _SIGNATURES[_name]


class _Kernels:
    """The loaded libraries: C function name -> ctypes function."""

    def __init__(self):
        self.fns: dict = {}
        self.build_seconds: float = 0.0
        self.ptxas_log: str = ""

    def build(self) -> None:
        out_dir = BUILD_ROOT / _digest()
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for src in SOURCES:
            lib = out_dir / (Path(src).stem + ".so")
            if lib.exists():
                continue
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            procs[src] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, lib)
        failed = []
        for src, (proc, tmp, lib) in procs.items():
            log, _ = proc.communicate()
            lib.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(src)
            else:
                os.replace(tmp, lib)
        # each source's nvcc log is kept beside its library, so a reused
        # build still reports its registers and spills
        self.ptxas_log = "\n".join(
            f"== {src}\n{log.read_text()}" for src in SOURCES
            if (log := out_dir / (Path(src).stem + ".log")).exists())
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{self.ptxas_log}")
        self.build_seconds = time.perf_counter() - t0
        for src in SOURCES:
            lib = ctypes.CDLL(str(out_dir / (Path(src).stem + ".so")))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name, None)
                if fn is not None:
                    fn.argtypes = argtypes
                    fn.restype = _INT
                    self.fns[name] = fn

    def get(self, name: str):
        if not self.fns:
            self.build()
        return self.fns[name]


KERNELS = _Kernels()


def build() -> float:
    """Build (or reuse) and load every kernel; returns the build seconds."""
    if not KERNELS.fns:
        KERNELS.build()
    return KERNELS.build_seconds


def call(name: str, *args) -> None:
    """Call one C entry point and raise on a nonzero CUDA error code."""
    err = KERNELS.get(name)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_suffix(dtype: torch.dtype) -> str:
    if dtype == torch.float64:
        return "f64"
    if dtype == torch.float32:
        return "f32"
    raise TypeError(f"the CUDA kernels take float64 or float32, "
                    f"got {dtype}")
