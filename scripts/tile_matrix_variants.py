"""Build variants of B4's dense block kernel and time them on one card.

    python3 scripts/tile_matrix_variants.py VARIANTS

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc.
VARIANTS is a JSON object {name: [[old, new], ...]}, or the path of a file
that holds one: each variant is a copy of ``src/repro_torch/csrc`` under
``build/variants_b4/<name>`` with those text substitutions made in
``tile_matrix.cu`` (an empty list is the source as it stands), built with
the package's own nvcc flags, all variants at once.

For each case (the predict cross block of ``chip_smoke.py``, 8760 sorted
times against 512: k2 at T0 = 200 h and 2000 h, k1, "se", and k2 at
n2 = 511) it prints the share of entries inside the Wendland window and,
for each variant, the card's time per launch (CUDA events around 50
back-to-back launches after a warm-up, so the host's enqueue overlaps the
card's work) and whether it agrees with the plain version to 1e-12.  How
B4's layout was chosen (PERF.md).
"""

from __future__ import annotations

import ctypes
import json
import math
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels import kernel_matvec as km  # noqa: E402
from repro_torch.kernels import kernel_tile as kt  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "variants_b4"


def build(variants):
    """name -> the ctypes tile_matrix_f64 of each variant that built."""
    procs = {}
    for name, subs in variants.items():
        d = OUT / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(CSRC, d)
        src = d / "tile_matrix.cu"
        s = src.read_text()
        for old, new in subs:
            if old not in s:
                raise ValueError(f"{name}: {old!r} is not in the source")
            s = s.replace(old, new)
        src.write_text(s)
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(name, "failed to build:", log[-3000:])
            continue
        regs = cs.ptxas_rows(log, r"tile_matrix_kernelIdLi(\d)E",
                             lambda m: dict(kind=int(m.group(1))))
        print(name, "(f64 kind, registers, spill bytes):", json.dumps(
            [(r["kind"], r.get("registers"), r.get("spill_stores"))
             for r in regs]), flush=True)
        fn = ctypes.CDLL(str(OUT / name / "lib.so")).tile_matrix_f64
        fn.argtypes = _cuda._SIGNATURES["tile_matrix_f64"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def loop_ms(go, reps=50):
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
    arg = argv[1]
    path = pathlib.Path(arg)
    variants = json.loads(path.read_text() if path.exists() else arg)
    fns = build(variants)
    print(torch.cuda.get_device_name(0), flush=True)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    x = torch.tensor(np.sort(rng.uniform(0, 8760, cs.N)), device=dev)
    xs = torch.tensor(np.sort(rng.uniform(0, 8760, cs.N_STAR)), device=dev)
    k2 = cs.THETA["k2"]
    cases = {"k2": ("k2", k2, xs),
             "k2_t0_2000": ("k2", [math.log(2000.0)] + k2[1:], xs),
             "k1": ("k1", cs.THETA["k1"], xs),
             "se": ("se", [math.log(40.0)], xs),
             "k2_n511": ("k2", k2, xs[:cs.N_STAR - 1].contiguous())}
    for label, (kind, theta, x2) in cases.items():
        p = ops.natural_params(kind, torch.tensor(
            theta, dtype=torch.float64)).to(dev)
        n1, n2 = x.shape[0], x2.shape[0]
        want = kt.tile_matrix_plain(kind, p, x, x2)
        res = {"case": label, "n2": n2, "support_share":
               km.support_entries(kind, p, x, x2) / (n1 * n2)}
        for name, fn in fns.items():
            out = torch.empty((n1, n2), dtype=x.dtype, device=dev)

            def go():
                err = fn(_cuda.KIND_IDS[kind], p.data_ptr(), x.data_ptr(),
                         n1, x2.data_ptr(), n2, out.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            go()
            torch.cuda.synchronize()
            ok = cs.errors(out, want)[1] <= 1e-12
            res[name] = (loop_ms(go), ok)
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main(sys.argv)
