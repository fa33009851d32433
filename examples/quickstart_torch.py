"""Quickstart on the PyTorch/CUDA port (the twin of examples/quickstart.py).

Draw data from the k2 GP (paper Fig. 1), declare the candidate models as
GPSpecs, compare them by Laplace hyperevidence (eq. 2.13 + 2.19) with
``repro_torch.gp.compare``, and predict (eq. 2.1) from a fitted session.
At n = 100 ``backend="auto"`` binds the dense backend (one Cholesky per
likelihood evaluation, ``torch.linalg``).  The core flow is three lines:

    gp = GP.bind(spec, x, y).fit(key)     # multi-start NCG (eqs. 2.16/2.17)
    lnz = gp.log_evidence().log_z         # Laplace hyperevidence (eq. 2.13)
    post = gp.predict(xstar)              # GPR posterior (eq. 2.1)

    python examples/quickstart_torch.py [--device cpu]

Everything runs on the card unless ``--device cpu``.  The port draws its
random numbers with torch (``repro_torch.random``), so the data and the
numbers printed differ from the JAX example's.
"""

import argparse
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

from repro_torch import gp  # noqa: E402
from repro_torch import random as rnd  # noqa: E402
from repro_torch.data.synthetic import synthetic  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    ds = synthetic(rnd.key(42), 100, "k2", device=args.device)
    print(f"data: n={ds.x.shape[0]}, sigma_n={ds.sigma_n}")

    specs = gp.spec_bank(["k1", "k2"],
                         noise=gp.NoiseModel(sigma_n=ds.sigma_n))
    reports = gp.compare(specs, ds.x, ds.y, key=rnd.key(0),
                         device=ds.x.device)
    for r in reports:
        print(f"\n{r.name}: ln P_max = {r.log_p_max:.2f}   "
              f"ln Z_laplace = {r.log_z_laplace:.2f}   "
              f"likelihood evals = {r.n_evals_train}")
        print(f"  theta_hat = {np.round(r.theta_hat.cpu().numpy(), 3)}")
        print(f"  sigma_f_hat = {r.sigma_f_hat:.3f}   "
              f"errors = {np.round(r.errors.cpu().numpy(), 3)}")
    lnb = reports[1].log_z_laplace - reports[0].log_z_laplace
    print(f"\nln B (k2 vs k1) = {lnb:.2f}  "
          f"({'k2' if lnb > 0 else 'k1'} favoured)")

    # fit -> evidence -> predict through one bound session
    best = max(reports, key=lambda r: r.log_z_laplace)
    sess = gp.GP.bind(gp.as_spec(best.name,
                                 noise=gp.NoiseModel(ds.sigma_n)),
                      ds.x, ds.y, device=ds.x.device).fit(rnd.key(1))
    xs = torch.linspace(float(ds.x[0]), float(ds.x[-1]), 7,
                        dtype=torch.float64)
    post = sess.predict(xs)
    print(f"\ninterpolant ({best.name}) at {xs.numpy().round(1)}:")
    print(f"  mean = {post.mean.cpu().numpy().round(3)}")
    print(f"  std  = {np.sqrt(post.var.cpu().numpy()).round(3)}")


if __name__ == "__main__":
    main()
