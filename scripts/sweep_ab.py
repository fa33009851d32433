"""Time the tile sweeps of one checkout on the card, for A/B runs.

    python3 scripts/sweep_ab.py TREE LABEL

TREE is the root of a checkout (this one, or a parent commit unpacked
with ``git archive`` into a git-ignored directory); the script imports
that tree's ``repro_torch`` and ``chip_smoke.py``, builds its kernels and
prints one JSON line: LABEL and the time per call (``chip_smoke.time_ms``,
median of single calls) of B1 (k2, n = 8760, b = 9), B4 (the predict cross block, 8760 x 512, k2;
alone also at n2 = 511 and for "se"), B2 (k2, m = 5, and
at the stochastic 1-D stage's shape: "se", n = 65536, b = 9, m = 1), B3
(k2, b = 9 and 1), B8 and B9 (4096 scattered (n, 2) points, "se*matern32",
b = 9; B9 also at the stochastic (n, 2) stage's shape, 65536 points,
m = 2), B5 (b = 9), B6 (k2, m = 5) and B7 (B = 4, c = 9) on the SKI
cell of ``chip_smoke.py``, B10 (its product-SKI cell, b = 1, 9 and 256)
and B11 (b = 9: m = 2 and, "k2*se", m = 6 on the cell, m = 2 on the long
field beyond the float64 line cap), B12 (b = 2048 and 8 rows of n2 = 65536, "se", k = 9) and B13
(b = 2048, "se*matern32", k = 9 and 256), and B5 at b = 256.  The keys
ending in ``_dev`` give the card's time alone for B2, B3 (b = 9), B4, B5
(b = 9 and 256), B6, B7, B8, B9 (4096 points), B10, B11 (on the cell) and
B13: 20 calls
captured in one CUDA graph and replayed
(CUDA events around the replay, over 20), so the host's work per call,
which the other keys include, drops out.  Compare
two commits only within one call, in turns (parent, change, change,
parent), each in its own process.
"""

from __future__ import annotations

import json
import pathlib
import sys


def main(tree: str, label: str) -> None:
    root = pathlib.Path(tree).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import kernel_matvec as km
    from repro_torch.kernels import kernel_tile as kt
    from repro_torch.kernels import operators as opers
    from repro_torch.kernels import ops
    from repro_torch.kernels import ski_fused as sf

    _cuda.build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)

    def t64(a):
        return torch.tensor(a, dtype=torch.float64)

    def graph_ms(fn, calls=20, replays=5):
        """The card's time per call: ``calls`` calls in one CUDA graph."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # relaxed: the sweeps set their kernels' shared-memory attribute
        # (not a stream operation) while the graph is captured
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(calls):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(replays):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / calls)
        del graph
        return sorted(times)[len(times) // 2]

    res = {"tree": label}
    x = torch.tensor(np.sort(rng.uniform(0, 8760, 8760)), device=dev)
    p2 = ops.natural_params("k2", t64(cs.THETA["k2"])).to(dev)
    pd = ops.natural_tangents("k2", t64(cs.THETA["k2"])).to(dev)
    pdot = pd[0] + 0.3 * pd[1]
    v9 = torch.tensor(rng.standard_normal((8760, 9)), device=dev)
    res["B1_k2_b9"] = cs.time_ms(
        lambda: km.tile_matvec("k2", p2, x, x, v9), 20)
    res["B2_k2_m5"] = cs.time_ms(
        lambda: km.tile_stacked_tangent_matvec("k2", p2, pd, x, x, v9), 10)
    res["B3_k2_b9"] = cs.time_ms(
        lambda: km.tile_jvp("k2", p2, pdot, x, x, v9), 10)
    res["B2_k2_m5_dev"] = graph_ms(
        lambda: km.tile_stacked_tangent_matvec("k2", p2, pd, x, x, v9))
    res["B3_k2_b9_dev"] = graph_ms(
        lambda: km.tile_jvp("k2", p2, pdot, x, x, v9))
    xs512 = torch.tensor(np.sort(rng.uniform(0, 8760, 512)), device=dev)
    xs511 = xs512[:511].contiguous()
    res["B4_k2"] = cs.time_ms(lambda: kt.tile_matrix("k2", p2, x, xs512), 20)
    res["B4_k2_dev"] = graph_ms(lambda: kt.tile_matrix("k2", p2, x, xs512))
    res["B4_k2_n511_dev"] = graph_ms(
        lambda: kt.tile_matrix("k2", p2, x, xs511))
    p_se = ops.natural_params("se", t64([np.log(40.0)])).to(dev)
    res["B4_se_dev"] = graph_ms(lambda: kt.tile_matrix("se", p_se, x, xs512))
    v1 = v9[:, :1].contiguous()
    res["B3_k2_b1"] = cs.time_ms(
        lambda: km.tile_jvp("k2", p2, pdot, x, x, v1), 10)
    xs, _, _ = cs.make_stochastic_data(0, cs.STOCHASTIC_N)
    xs = torch.tensor(xs, device=dev)
    pse = ops.natural_params("se", t64(cs.ROWS_THETA["se"])).to(dev)
    pdse = ops.natural_tangents("se", t64(cs.ROWS_THETA["se"])).to(dev)
    vs9 = torch.tensor(rng.standard_normal((cs.STOCHASTIC_N, 9)), device=dev)
    res["B2_se_stochastic"] = cs.time_ms(
        lambda: km.tile_stacked_tangent_matvec("se", pse, pdse, xs, xs, vs9),
        3)
    kinds = ("se", "matern32")
    th = t64(cs.ND_THETA["se*matern32"])
    pn = ops.natural_params_nd("se*matern32", th).to(dev)
    pdn = ops.natural_tangents_nd("se*matern32", th).to(dev)
    X, _, _ = cs.make_scattered_field(0, 4096)
    X = torch.tensor(X, device=dev)
    w9 = torch.tensor(rng.standard_normal((4096, 9)), device=dev)
    res["B8_b9"] = cs.time_ms(
        lambda: km.tile_matvec_nd(kinds, pn, X, X, w9), 20)
    res["B8_b9_dev"] = graph_ms(lambda: km.tile_matvec_nd(kinds, pn, X, X,
                                                          w9))
    res["B9_m2"] = cs.time_ms(
        lambda: km.tile_stacked_tangent_matvec_nd(kinds, pn, pdn, X, X, w9),
        10)
    res["B9_m2_dev"] = graph_ms(
        lambda: km.tile_stacked_tangent_matvec_nd(kinds, pn, pdn, X, X, w9))
    Xs9, _, _ = cs.make_scattered_field(0, 65536)
    Xs9 = torch.tensor(Xs9, device=dev)
    u9s = torch.tensor(rng.standard_normal((65536, 9)), device=dev)
    res["B9_stochastic"] = cs.time_ms(
        lambda: km.tile_stacked_tangent_matvec_nd(kinds, pn, pdn, Xs9, Xs9,
                                                  u9s), 3)
    del Xs9, u9s
    xt, _, _, _ = cs.make_tidal_data(0)
    sop = opers.select_operator("k2", torch.tensor(xt, device=dev),
                                cs.TIDAL_SIGMA_N, 1e-8)
    sgeom = sop.fused_geom
    sth = torch.tensor(cs.SKI_THETA["k2"], dtype=torch.float64, device=dev)
    lam5 = sf.spectrum(opers.ToeplitzOperator("k2", sop.grid).first_column(
        sth), sgeom)
    lam6 = sf.spectrum(opers.ToeplitzOperator("k2", sop.grid)
                       .first_column_jacobian(sth), sgeom)
    lam7 = cs.bank_spectra(sop, 4, torch.float64)
    s9 = torch.tensor(rng.standard_normal((sgeom.n, 9)), device=dev)
    s49 = torch.tensor(rng.standard_normal((sgeom.n, 4, 9)), device=dev)
    s256 = torch.tensor(rng.standard_normal((sgeom.n, 256)), device=dev)
    for b, sv in ((9, s9), (256, s256)):
        res[f"B5_b{b}"] = cs.time_ms(
            lambda: sf.fused_gram_matvec(sgeom, lam5, sop.noise2, sv), 20)
        res[f"B5_b{b}_dev"] = graph_ms(
            lambda: sf.fused_gram_matvec(sgeom, lam5, sop.noise2, sv))
    res["B6_k2_m5"] = cs.time_ms(
        lambda: sf.fused_tangent_matvecs(sgeom, lam6, s9), 20)
    res["B6_k2_m5_dev"] = graph_ms(
        lambda: sf.fused_tangent_matvecs(sgeom, lam6, s9))
    res["B7_B4_c9"] = cs.time_ms(
        lambda: sf.fused_bank_matvec(sgeom, lam7, sop.noise2, s49), 20)
    res["B7_B4_c9_dev"] = graph_ms(
        lambda: sf.fused_bank_matvec(sgeom, lam7, sop.noise2, s49))
    xf, _, _ = cs.make_field(0)
    op = opers.select_operator(cs.ND_KIND, torch.tensor(xf, device=dev),
                               cs.FIELD_SIGMA_N, 1e-8)
    geom = op.fused_geom
    lams = sf.spectrum_nd(op._kron.first_columns(th.to(dev)), geom)
    for b in (1, 9, 256):
        vb = torch.tensor(rng.standard_normal((geom.n, b)), device=dev)
        res[f"B10_b{b}"] = cs.time_ms(
            lambda: sf.fused_gram_matvec_nd(geom, lams, op.noise2, vb), 20)
        res[f"B10_b{b}_dev"] = graph_ms(
            lambda: sf.fused_gram_matvec_nd(geom, lams, op.noise2, vb))
    pairs = sf.tangent_spectra_nd(op._kron, th.to(dev), geom, torch.float64)
    v9 = torch.tensor(rng.standard_normal((geom.n, 9)), device=dev)
    res["B11_m2"] = cs.time_ms(
        lambda: sf.fused_tangent_matvecs_nd(geom, pairs, v9), 20)
    res["B11_m2_dev"] = graph_ms(
        lambda: sf.fused_tangent_matvecs_nd(geom, pairs, v9))
    th6 = t64(cs.ND_THETA["k2*se"]).to(dev)
    op6 = opers.select_operator("k2*se", torch.tensor(xf, device=dev),
                                cs.FIELD_SIGMA_N, 1e-8)
    pairs6 = sf.tangent_spectra_nd(op6._kron, th6, op6.fused_geom,
                                   torch.float64)
    res["B11_k2se_m6"] = cs.time_ms(
        lambda: sf.fused_tangent_matvecs_nd(op6.fused_geom, pairs6, v9), 20)
    res["B11_k2se_m6_dev"] = graph_ms(
        lambda: sf.fused_tangent_matvecs_nd(op6.fused_geom, pairs6, v9))
    xl, _, _ = cs.make_field(0, shape=cs.LONG_FIELD_SHAPE)
    opl = opers.select_operator(cs.ND_KIND, torch.tensor(xl, device=dev),
                                cs.FIELD_SIGMA_N, 1e-8)
    pairsl = sf.tangent_spectra_nd(opl._kron, th.to(dev), opl.fused_geom,
                                   torch.float64)
    vl = torch.tensor(rng.standard_normal((opl.fused_geom.n, 9)), device=dev)
    res["B11_beyond_cap"] = cs.time_ms(
        lambda: sf.fused_tangent_matvecs_nd(opl.fused_geom, pairsl, vl), 20)
    xs, _, _ = cs.make_stochastic_data(0, 65536)
    xs = torch.tensor(xs, device=dev)
    ps = ops.natural_params("se", t64(cs.ROWS_THETA["se"])).to(dev)
    u9 = torch.tensor(rng.standard_normal((65536, 9)), device=dev)
    for b in (2048, 8):
        xb = xs[torch.tensor(rng.permutation(65536)[:b], device=dev)]
        res[f"B12_b{b}_k9"] = cs.time_ms(
            lambda: km.tile_matvec_rows("se", ps, xb, xs, u9), 20)
    Xs, _, _ = cs.make_scattered_field(0, 65536)
    Xs = torch.tensor(Xs, device=dev)
    Xb = Xs[torch.tensor(rng.permutation(65536)[:2048], device=dev)]
    res["B13_k9"] = cs.time_ms(
        lambda: km.tile_matvec_rows_nd(kinds, pn, Xb, Xs, u9), 10)
    res["B13_k9_dev"] = graph_ms(
        lambda: km.tile_matvec_rows_nd(kinds, pn, Xb, Xs, u9), 5)
    u256 = torch.tensor(rng.standard_normal((65536, 256)), device=dev)
    res["B13_k256"] = cs.time_ms(
        lambda: km.tile_matvec_rows_nd(kinds, pn, Xb, Xs, u256), 5)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
