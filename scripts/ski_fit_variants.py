"""Fit the SKI cell of ``chip_smoke.py`` under one variant of its matvec or
budget, on the card, and print one JSON line.

    python3 scripts/ski_fit_variants.py TREE VARIANT

The cell (its data, boxes, key and ``chip_smoke.ski_policy``: 2 starts of
25 NCG steps, 64 scan points, CG cut at ``SKI_CG_MAX_ITER``) comes from this
checkout's ``chip_smoke.py``; the port it runs on comes from TREE, the root
of a checkout (this one, or a parent commit unpacked with ``git archive``
into a git-ignored directory), whose ``src/repro_torch`` is imported.  The
script runs the cell's sequential k2 fit and ``log_evidence``.  VARIANT is
one or more of, joined by "+":

  default      the cell as it is;
  splitL1xL2   B5's four steps on the split L1 x L2 (e.g. split64x256), set
               on the bound operator's geometry, in place of the plan's own
               (trees with ``gram_1d_plan``);
  unfused      SolverOpts(fused=False): the unfused composition on
               ``torch.fft`` instead of B5;
  cgN          the CG cap N instead of the cell's (e.g. cg800, the
               library's default);
  itersN       N NCG steps instead of 25.

The variants that change only the matvec's rounding (the splits, unfused,
another tree's kernel) show how far the fit's answer depends on it: where
the cut CG solves carry the gradient, ln P_max and the Laplace Hessian
move with rounding.  The line holds the stage times, ln P_max, ln Z, the
evaluations, how the CG solves ended and the Hessian's eigenvalues.
Several variants may run side by side on one card (each is host-bound),
but their times are then not comparable with a run alone.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]


def main(tree: str, variants: str) -> None:
    root = pathlib.Path(tree).resolve()
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(root / "src"))
    import torch

    # TREE's package first: chip_smoke puts its own src on the path
    from repro_torch import gp
    from repro_torch import random as rnd
    from repro_torch.core import iterative as it
    from repro_torch.core import laplace
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import ski_fused as sf

    import chip_smoke as cs

    kw, split = {}, None
    for variant in variants.split("+"):
        if variant.startswith("split"):
            if not hasattr(sf, "gram_1d_plan"):
                raise SystemExit(f"{tree} has no four-step split")
            split = tuple(map(int, variant[len("split"):].split("x")))
        elif variant == "unfused":
            kw["fused"] = False
        elif variant.startswith("cg"):
            kw["cg_max_iter"] = int(variant[len("cg"):])
        elif variant.startswith("iters"):
            kw["max_iters"] = int(variant[len("iters"):])
        elif variant != "default":
            raise SystemExit(f"unknown variant {variant!r}")
    seed = 0
    x_np, y_np, _, _ = cs.make_tidal_data(seed)
    policy = cs.ski_policy(**kw)
    spec = gp.GPSpec("k2", box=cs.tidal_boxes()["k2"],
                     noise=gp.NoiseModel(sigma_n=cs.TIDAL_SIGMA_N),
                     solver=policy)
    kfit, kev, _ = rnd.split(rnd.key(seed + 1000), 3)
    session = gp.GP.bind(spec, x_np, y_np)
    if split is not None:
        session.op.fused_geom.split = split
    _cuda.reset_launches()
    it.reset_cg_stops()
    t0 = time.perf_counter()
    fitted = session.fit(kfit)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_stops = dict(it.CG_STOPS)
    it.reset_cg_stops()
    laplace.HESSIAN_EIGENVALUES.clear()
    t0 = time.perf_counter()
    ev = fitted.log_evidence(key=kev)
    torch.cuda.synchronize()
    ev_s = time.perf_counter() - t0
    r = fitted.result
    print(json.dumps(dict(
        tree=tree, variant=variants, cg_max_iter=policy.opts.cg_max_iter,
        fused=session.op.fused, fit_s=fit_s, ev_s=ev_s,
        log_p_max=float(r.log_p_max), log_p_all=r.log_p_all.tolist(),
        n_evals=r.n_evals, theta=r.theta_hat.tolist(),
        log_z=float(ev.log_z), fit_stops=fit_stops,
        ev_stops=dict(it.CG_STOPS),
        hess=[h.tolist() for h in laplace.HESSIAN_EIGENVALUES],
        launches=dict(_cuda.LAUNCHES))), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
