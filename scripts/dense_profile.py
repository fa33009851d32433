"""Where the dense path's time goes on one card: wall time and device time
of its evaluations.

    python3 scripts/dense_profile.py [--seed S] [--repeats R]

Run from the root of a checkout on a machine with an NVIDIA GPU (it
builds no kernel: the dense path runs none).  For k2 on the two records
of ``chip_smoke.py``'s dense phase (the quickstart record, n = 100, and
the six-month tide record, n = 1967), at a fixed point of its box, it
times each piece that a fit and its Laplace stage run:

  * ``value``: ln P_max (one Cholesky; an Armijo probe of the trainer);
  * ``value_and_grad``: ln P_max and its gradient (the trainer's step:
    the Cholesky, K^-1 and the jvp stack of dK);
  * ``hessian``: the analytic Hessian of eq. 2.19 (the Laplace stage);
  * ``scan64``: 64 scan points (a batched Cholesky per chunk).

For each piece it prints one JSON line with the wall time per call (host
clock around ``torch.cuda.synchronize()``, median of R calls after a
warm-up), the device's busy time per call under ``torch.profiler`` (the
union of the device activities' intervals over R calls, divided by R),
the device's idle share (1 - busy / wall), the device activities
(kernels, copies, fills) per call and the five operators that take most
host time.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

from repro_torch import random as rnd  # noqa: E402
from repro_torch.core import covariances as C  # noqa: E402
from repro_torch.core import hyperlik as hl  # noqa: E402
from repro_torch.core.reparam import flat_box, sample_uniform  # noqa: E402
from repro_torch.data.synthetic import synthetic  # noqa: E402
from repro_torch.data.tidal import woods_hole_like  # noqa: E402

# k2 points inside each record's data-dependent box (flat coordinates)
THETA = {"quickstart": [3.5, 1.5, 0.0, 3.0, 0.0],
         "tide": [6.06, math.log(12.42), 0.09, math.log(24.0), 0.28]}


def pieces(ds, theta, cand):
    cov = C.K2
    x, y, s = ds.x, ds.y, ds.sigma_n

    def value():
        return hl.profiled_loglik(cov, theta, x, y, s)[0]

    def value_and_grad():
        v, cache = hl.profiled_loglik(cov, theta, x, y, s)
        return v, hl.profiled_grad(cov, theta, x, y, s, cache)

    def hessian():
        _, cache = hl.profiled_loglik(cov, theta, x, y, s)
        return hl.profiled_hessian(cov, theta, x, y, s, cache)

    def scan64():
        return hl.profiled_loglik_batch(cov, cand, x, y, s)

    return {"value": value, "value_and_grad": value_and_grad,
            "hessian": hessian, "scan64": scan64}


def measure(fn, repeats):
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    device = sorted((e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf      # the union of the device intervals
    for a, b in device:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    top = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                 reverse=True)[:5]
    wall = statistics.median(walls)
    busy = busy_us * 1e-6 / repeats
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy * 1e3,
                idle_share=1.0 - busy / wall,
                kernel_launches=len(device) / repeats,
                top_host_ops=[(e.key, e.self_cpu_time_total / repeats / 1e3)
                              for e in top])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dense_profile: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    records = {"quickstart": synthetic(rnd.key(42 + args.seed), 100, "k2"),
               "tide": woods_hole_like(rnd.key(args.seed), months=6)}
    for name, ds in records.items():
        theta = torch.tensor(THETA[name], dtype=torch.float64,
                             device=ds.x.device)
        cand = sample_uniform(rnd.key(1), C.K2, flat_box(C.K2, ds.x), (64,))
        for piece, fn in pieces(ds, theta, cand).items():
            repeats = max(2, args.repeats // 10) if piece in (
                "hessian", "scan64") else args.repeats
            print(json.dumps({"dense_profile": dict(
                record=name, n=int(ds.x.shape[0]), piece=piece,
                repeats=repeats, **measure(fn, repeats))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
