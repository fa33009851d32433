"""Build variants of B2's and B3's register kernels and time them on one card.

    python3 scripts/tangent_sweep_variants.py VARIANTS CASES

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc.
VARIANTS is a JSON object {name: [[file, old, new], ...]}: each variant is
a copy of ``src/repro_torch/csrc`` under ``build/tangent_variants/<name>``
with those text substitutions made in the named headers (an empty list is
the source as it stands), from which ``tile_tangent.cu`` and
``tile_jvp.cu`` are built with the package's own nvcc flags, all variants
at once.  CASES is a comma-separated list of case names from ``cases``
below; a case whose name ends in ``_zN`` runs B2 as N launches, each on
its own slice of V's columns (the cost of splitting V over the grid's z
axis: every slice evaluates the gradient again).

For each variant it prints the registers and spill stores ptxas reports
for the float64 kernels of k2 and se; for each case, per variant, the
card's time per call (CUDA events around 30 back-to-back calls after a
warm-up, so the host's enqueue overlaps the card's work) and whether it
agrees with the plain version to 1e-11.  How B2's register layout was
chosen (PERF.md).
"""

from __future__ import annotations

import ctypes
import json
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
OUT = ROOT / "build" / "tangent_variants"
SOURCES = ("tile_tangent.cu", "tile_jvp.cu")


def build(variants):
    """name -> {C symbol: ctypes function} of each variant that built."""
    procs = {}
    for name, subs in variants.items():
        d = OUT / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(CSRC, d)
        for file, old, new in subs:
            h = d / file
            s = h.read_text()
            if old not in s:
                raise ValueError(f"{name}: {old!r} is not in {file}")
            h.write_text(s.replace(old, new))
        for src in SOURCES:
            lib = d / (pathlib.Path(src).stem + ".so")
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib),
                   str(d / src)]
            procs[(name, src)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    fns, logs = {}, {}
    for (name, src), (proc, lib) in procs.items():
        log, _ = proc.communicate()
        logs[name] = logs.get(name, "") + log
        if proc.returncode:
            print(name, src, "failed to build:", log[-3000:], flush=True)
            fns[name] = None
            continue
        if fns.get(name, {}) is None:
            continue
        handle = ctypes.CDLL(str(lib))
        for sym in ("tile_tangent_f64", "tile_tangent_rows", "tile_jvp_f64"):
            fn = getattr(handle, sym, None)
            if fn is not None:
                fn.argtypes = _cuda._SIGNATURES[sym]
                fn.restype = ctypes.c_int
                fns.setdefault(name, {})[sym] = fn
    for name, log in logs.items():
        regs = [(r["kernel"], r["path"], r["kind"], r.get("width"),
                 r["registers"], r["spill_stores"])
                for r in cs.tangent_ptxas(log)
                if r["dtype"] == "float64" and r["kind"] in (1, 2)]
        print(name, "(kernel, path, kind, width, registers, spill bytes):",
              json.dumps(regs), flush=True)
    return {k: v for k, v in fns.items() if v}


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
    variants = json.loads(argv[1])
    t0 = time.time()
    fns = build(variants)
    print("build_s", time.time() - t0, flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    x = torch.tensor(np.sort(rng.uniform(0, 8760, cs.N)), device=dev)
    xs, _, _ = cs.make_stochastic_data(0, cs.STOCHASTIC_N)
    xs = torch.tensor(xs, device=dev)
    k2 = cs.THETA["k2"]
    # (B2 or B3, kind, theta, x, b, V column slices)
    cases = {"B2_k2_b9": ("B2", "k2", k2, x, 9, [9]),
             "B2_k2_b9_z2": ("B2", "k2", k2, x, 9, [5, 4]),
             "B2_k2_b9_z3": ("B2", "k2", k2, x, 9, [3, 3, 3]),
             "B2_k2_b1": ("B2", "k2", k2, x, 1, [1]),
             "B2_k1_b9": ("B2", "k1", k2[:3], x, 9, [9]),
             "B2_se_stochastic": ("B2", "se", cs.ROWS_THETA["se"], xs, 9,
                                  [9]),
             "B3_k2_b9": ("B3", "k2", k2, x, 9, [9]),
             "B3_k2_b1": ("B3", "k2", k2, x, 1, [1])}
    for label in argv[2].split(","):
        op, kind, theta, xx, b, slices = cases[label]
        th = torch.tensor(theta, dtype=torch.float64)
        p = ops.natural_params(kind, th).to(dev)
        pd = ops.natural_tangents(kind, th).to(dev)
        if op == "B3":
            pd = pd[:1].contiguous()
        m, n = pd.shape[0], xx.shape[0]
        v = torch.tensor(rng.standard_normal((n, b)), device=dev)
        want = km.tile_stacked_tangent_matvec_plain(kind, p, pd, xx, xx, v)
        res = {"case": label}
        for name, f in fns.items():
            sym = "tile_tangent_f64" if op == "B2" else "tile_jvp_f64"
            if sym not in f:
                continue
            out = torch.empty((m, n, b), dtype=v.dtype, device=dev)
            calls, j0 = [], 0
            for w in slices:
                rows = (f["tile_tangent_rows"](_cuda.KIND_IDS[kind], w)
                        if op == "B2" else km.VALUE_ROWS)
                segs, seg_cols = km.row_segments(
                    n, n, sms, (rows, km.VALUE_COLS, km.VALUE_BLOCKS_PER_SM,
                                km.VALUE_WARPS))
                part = (torch.empty((segs, m, n, w), dtype=v.dtype,
                                    device=dev) if segs > 1 else None)
                calls.append((j0, w, segs, seg_cols, part))
                j0 += w

            def go():
                for j0, w, segs, seg_cols, part in calls:
                    err = f[sym](_cuda.KIND_IDS[kind], p.data_ptr(),
                                 pd.data_ptr(), m, xx.data_ptr(), n,
                                 xx.data_ptr(), n, v.data_ptr() + 8 * j0, b,
                                 w, seg_cols, segs,
                                 None if part is None else part.data_ptr(),
                                 out.data_ptr() + 8 * j0, b, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
            go()
            torch.cuda.synchronize()
            ok = cs.errors(out, want)[1] <= 1e-11
            res[name] = (loop_ms(go, 10 if n > cs.N else 30), ok)
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main(sys.argv)
