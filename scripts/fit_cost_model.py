"""Fit the port's Hopper cost model (``repro_torch.core.mesh_sim.RATES``)
to the card's own times in a ``chip_smoke.py`` log.

    python scripts/fit_cost_model.py LOG [LOG ...]

LOG holds the smoke's standard output (one JSON object a line). The points:

* the InCRS orders: every measured candidate of every ``autotune`` sweep
  (its order, launch geometry, stripes and padded width);
* index matching: the ``autotune`` sweep at mesh-docword4 (round window
  and geometry), and each ``spgemm_operand`` line's ring time;
* condense, merge and the gather: each ``spgemm_operand`` line's time of
  the instance the rule picks.

Each kernel's three constants (``wave_us``, ``bytes_per_us``,
``fma_per_us``) are fitted by least squares on log(predicted / measured),
Nelder-Mead over their logs, from ``RATES`` as it stands. Prints the
``RATES`` entries and, per kernel, the points and the spread of
measured / predicted before and after. Runs on the CPU: it reads numbers,
it measures none.
"""
from __future__ import annotations

import json
import math
import os
import sys

import numpy as np
from scipy.optimize import minimize

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core import mesh_sim as ms                    # noqa: E402
from repro_torch.kernels import incrs_gather as G              # noqa: E402
from repro_torch.kernels import incrs_spmm as K                # noqa: E402
from repro_torch.kernels import index_match_spmm as IM         # noqa: E402
from repro_torch.spgemm import kernels as SK                   # noqa: E402


def _lines(paths):
    for path in paths:
        with open(path) as f:
            for ln in f:
                if ln.startswith("{"):
                    yield json.loads(ln)


def _geometry(variant, g):
    if variant == "pipelined":
        return K.PipeGeometry(*g)
    if variant == "index_match":
        return IM.MatchGeometry(*g)
    return tuple(g)


def points(paths):
    """{kernel: [(waves, bytes, fmas, measured µs), ...]}."""
    out = {k: [] for k in ms.RATES}
    for line in _lines(paths):
        if line.get("phase") == "autotune" and "stripes" in line:
            m, n_sec, smax = line["stripes"]
            for c in line["measured"]:
                cost = ms.fused_spmm_cost(
                    c["variant"], m, line["n_padded"], n_sections=n_sec,
                    smax=smax, section=line["section"],
                    geometry=_geometry(c["variant"], c["geometry"]))
                out[c["variant"]].append((cost.waves, cost.hbm_bytes,
                                          cost.fmas, c["us"]))
        elif line.get("phase") == "autotune" and "prep" in line:
            for c in line["measured"]:
                mp, n_rounds, rmax = line["prep"][str(c["rounds"])]
                geo = _geometry("index_match", c["geometry"])
                ctas, waves, nbytes, fmas = ms._match_terms(
                    mp, mp, rounds=c["rounds"], n_rounds=n_rounds,
                    rmax_a=rmax, rmax_b=rmax, stripes=False, geometry=geo)
                out["index_match"].append((waves, nbytes, fmas, c["us"]))
        elif line.get("phase") == "spgemm_operand":
            mp, n_rounds, rmax = line["prep"]
            rounds = line["rounds"]
            for kernel, key in (("index_match_spmm", "index_match"),
                                ("spgemm_condense", "condense")):
                row = line.get(kernel)
                if not row:
                    continue
                ctas, waves, nbytes, fmas = ms._match_terms(
                    mp, mp, rounds=rounds, n_rounds=n_rounds, rmax_a=rmax,
                    rmax_b=rmax, stripes=kernel == "spgemm_condense")
                out[key].append((waves, nbytes, fmas,
                                 row[f"{row['picked']}_ms"] * 1e3))
            mg = line["spgemm_merge"]
            geo = SK.merge_geometry(mp * mp, n_rounds)
            per_sm = SK.merge_ctas(geo.smem) if geo.smem else 1
            out["merge"].append((ms._waves(geo.grid, per_sm),
                                 (n_rounds + 1) * mp * mp * 4, 0,
                                 mg[f"{mg['picked']}_ms"] * 1e3))
            gr = line.get("incrs_gather")
            if gr:
                m8, n_sec, smax, section = gr["stripes"]
                gg = G.gather_geometry(m8, n_sec, smax, section)
                out["gather"].append((
                    ms._waves(gg.grid, gg.ctas_per_sm or 1),
                    m8 * n_sec * smax * 8 + m8 * n_sec * section * 4, 0,
                    gr[f"{gr['picked']}_ms"] * 1e3))
    return out


def _pred(params, pts):
    wave, bw, fma = (math.exp(p) for p in params)
    return np.array([w * wave + max(b / bw, f / fma) for w, b, f, _ in pts])


def fit(kernel, pts):
    meas = np.array([u for *_, u in pts])
    r = ms.RATES[kernel]
    x0 = np.log([r.wave_us, r.bytes_per_us, r.fma_per_us])

    def loss(x):
        return float(np.sum((np.log(_pred(x, pts)) - np.log(meas)) ** 2))
    best = minimize(loss, x0, method="Nelder-Mead",
                    options={"xatol": 1e-4, "fatol": 1e-8, "maxiter": 20000})
    return best.x, loss(x0), best.fun


def main(argv) -> int:
    if not argv:
        print(__doc__)
        return 2
    pts = points(argv)
    print("RATES = {")
    for kernel, p in pts.items():
        if not p:
            r = ms.RATES[kernel]
            print(f"    # {kernel}: no points; kept")
            print(f'    "{kernel}": HopperRates({r.wave_us!r}, '
                  f'{r.bytes_per_us!r}, {r.fma_per_us!r}),')
            continue
        x, before, after = fit(kernel, p)
        wave, bw, fma = (float(math.exp(v)) for v in x)
        ratio = np.array([u for *_, u in p]) / _pred(x, p)
        print(f"    # {kernel}: {len(p)} points; sum of squared log "
              f"ratios {before:.3f} -> {after:.3f}; measured / predicted "
              f"{ratio.min():.2f}-{ratio.max():.2f} (median "
              f"{float(np.median(ratio)):.2f})")
        print(f'    "{kernel}": HopperRates({wave:.4g}, {bw:.4g}, '
              f'{fma:.4g}),')
    print("}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
