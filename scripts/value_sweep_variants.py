"""Build variants of the value sweep (B1, B12) and time them on one card.

    python3 scripts/value_sweep_variants.py VARIANTS GRIDS CASES

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc.
VARIANTS is a JSON object {name: [[old, new], ...]}: each variant is a
copy of ``src/repro_torch/csrc`` under ``build/variants/<name>`` with those
text substitutions made in ``value_sweep.cuh`` (an empty list is the
source as it stands), built from ``tile_matvec.cu`` with the package's own
nvcc flags, all variants at once.  GRIDS is a JSON object {name: [[rows,
per_sm], ...]}: the grids each variant is launched on (its stripe height
and ``kernel_matvec.row_segments``' blocks per SM).  CASES is a comma-
separated list of case names from ``CASES`` below.

For each variant it prints the registers and spill stores ptxas reports
for the f64 kernels of k2 and se; for each case the time of each variant
and grid (CUDA events around 30 back-to-back launches after a warm-up, so
the host's enqueue overlaps the card's work) and whether it agrees with
the plain version to 1e-12.  Narrow cases also give the public wrapper's
time per call (median of single calls, host overhead included) and
wide ones the plain version's.  How the launch bounds of the two kernels
were chosen (PERF.md).
"""

from __future__ import annotations

import ctypes
import json
import math
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels import kernel_matvec as km  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "variants"


def build(variants):
    """name -> the ctypes tile_matvec_f64 of each variant that built."""
    procs = {}
    for name, subs in variants.items():
        d = OUT / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(CSRC, d)
        h = d / "value_sweep.cuh"
        s = h.read_text()
        for old, new in subs:
            if old not in s:
                raise ValueError(f"{name}: {old!r} is not in the source")
            s = s.replace(old, new)
        h.write_text(s)
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "tile_matvec.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(name, "failed to build:", log[-3000:])
            continue
        regs = [(r["path"][0], r["kind"], r["width"], r["registers"],
                 r["spill_stores"]) for r in cs.value_ptxas(log)
                if r["dtype"] == "float64" and r["kind"] in (1, 2)]
        print(name, "(path, kind, width, registers, spill bytes):",
              json.dumps(regs))
        fn = ctypes.CDLL(str(OUT / name / "lib.so")).tile_matvec_f64
        fn.argtypes = _cuda._SIGNATURES["tile_matvec_f64"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def loop_ms(go, reps=30):
    go()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        go()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv):
    variants, grids = json.loads(argv[1]), json.loads(argv[2])
    t0 = time.time()
    fns = build(variants)
    print("build_s", time.time() - t0, flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    x = torch.tensor(np.sort(rng.uniform(0, 8760, 8760)), device=dev)
    xs, _, _ = cs.make_stochastic_data(0, 65536)
    xs = torch.tensor(xs, device=dev)
    xb = xs[torch.tensor(rng.permutation(65536)[:2048], device=dev)]
    k2 = cs.THETA["k2"]
    wide = [math.log(2000.0)] + k2[1:]
    se, rows_se = [math.log(50.0)], cs.ROWS_THETA["se"]
    cases = {"k2_200_b9": ("k2", k2, x, x, 9),
             "k2_200_b1": ("k2", k2, x, x, 1),
             "k2_2000_b9": ("k2", wide, x, x, 9),
             "se_b9": ("se", se, x, x, 9),
             "B12_se_k9": ("se", rows_se, xb, xs, 9),
             "B12_se_k1": ("se", rows_se, xb, xs, 1),
             "k2_200_b512": ("k2", k2, x, x, 512),
             "k2_2000_b512": ("k2", wide, x, x, 512),
             "se_b512": ("se", se, x, x, 512),
             "k2_200_b17": ("k2", k2, x, x, 17),
             "B12_se_k256": ("se", rows_se, xb, xs, 256)}
    for label in argv[3].split(","):
        kind, theta, x1, x2, b = cases[label]
        p = ops.natural_params(kind, torch.tensor(
            theta, dtype=torch.float64)).to(dev)
        v = torch.tensor(rng.standard_normal((x2.shape[0], b)), device=dev)
        want = km.tile_matvec_plain(kind, p, x1, x2, v)
        n1, n2 = x1.shape[0], x2.shape[0]
        res = {"case": label}
        if b > 16:
            res["plain_ms"] = loop_ms(
                lambda: km.tile_matvec_plain(kind, p, x1, x2, v), 5)
        else:
            res["wrapper_ms"] = cs.time_ms(
                lambda: km.tile_matvec(kind, p, x1, x2, v), 10)
        for name, fn in fns.items():
            for rows, per_sm in grids[name]:
                segs, seg_cols = km.row_segments(
                    n1, n2, sms, (rows, km.VALUE_COLS, per_sm, 1))
                out = torch.empty((n1, b), dtype=v.dtype, device=dev)
                part = (torch.empty((segs, n1, b), dtype=v.dtype,
                                    device=dev) if segs > 1 else None)

                def go():
                    err = fn(_cuda.KIND_IDS[kind], p.data_ptr(),
                             x1.data_ptr(), n1, x2.data_ptr(), n2,
                             v.data_ptr(), b, b, seg_cols, segs,
                             None if part is None else part.data_ptr(),
                             out.data_ptr(), b, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                go()
                torch.cuda.synchronize()
                ok = cs.errors(out, want)[1] <= 1e-12
                res[f"{name}/r{rows}/s{per_sm}"] = (loop_ms(go), ok)
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main(sys.argv)
