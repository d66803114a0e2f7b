"""Serving wall of the SpMM engine, one fresh process.

Serves phase 3's mixed-width trace of ``chip_smoke.py`` through a fresh
``SpMMEngine`` over incrs-docword, as InCRS and as a dense plan, twelve
times each, and prints one JSON line: each run's host wall from the first
submit to the results on the host, and the medians (the first run warms
and is left out) of the wall, the host's staging and the waves' summed
walls.

  python scripts/serve_ab.py SRC

SRC is the source tree to import ``repro_torch`` from (``src``, or the
``src`` of another commit unpacked by ``git archive``), so two commits
are compared on one card in turns. Needs a CUDA device.
"""

import json
import statistics
import sys
import time

import numpy as np


def main(src):
    sys.path.insert(0, src)
    import torch
    from repro_torch.configs.paper_spmm import WORKLOADS
    from repro_torch.core.incrs import InCRS
    from repro_torch.data import datasets
    from repro_torch.serve import engine as E
    from repro_torch.sparse import api

    wl = WORKLOADS["incrs-docword"]
    crs = datasets.synthesize(wl.dataset, seed=0)
    inc = InCRS.from_crs(crs, wl.section, wl.block)
    dense = api.plan_for_operand(crs.to_dense(), api.SparseSpec("dense"),
                                 device="cuda")
    rng = np.random.default_rng(1)
    widths = [(256, 128, 64, 384)[r % 4] for r in range(32)] + [1200]
    panels = [rng.normal(size=(12000, w)).astype(np.float32)
              for w in widths]
    out = {"src": src}
    for label, op in (("incrs", inc), ("dense", dense)):
        walls, stage, waves = [], [], []
        for _ in range(12):
            eng = E.SpMMEngine(op, max_wave_cols=512, device="cuda")
            t0 = time.perf_counter()
            for j, p in enumerate(panels):
                eng.submit(E.SpMMRequest(j, p))
            eng.run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            stage.append(eng.stats_summary()["prep_s_total"] * 1e3)
            waves.append(sum(eng._wave_wall_s) * 1e3)
        out[label] = {"median_ms": statistics.median(walls[1:]),
                      "walls": [round(w, 1) for w in walls],
                      "stage_ms_median": statistics.median(stage[1:]),
                      "wave_sum_ms_median": statistics.median(waves[1:])}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
