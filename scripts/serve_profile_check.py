"""Profiler check of the SpMM engine's copies, one fresh process.

Serves phase 3's mixed-width trace of ``chip_smoke.py`` (32 requests of
64–384 columns and one of 1,200) through fresh ``SpMMEngine``s over
granite-34b's W_up^T as a bsr plan (block 128, density 0.25, as
``chip_smoke.py``'s GRANITE) and over incrs-docword as InCRS, six times
each, plain and under torch.profiler (the last three sessions sleep 0.3 s
before the profiler stops). Prints one JSON line a session: the waves,
the plain and profiled walls, and for each kind of device record
(the format's kernel, H2D, D2H, other) its count and device ms.

  python scripts/serve_profile_check.py SRC [HOLD_GB]

With HOLD_GB, sessions 2–3 run after the caching allocator has reserved
HOLD_GB of device memory (one tensor made and dropped) and sessions 4–5
after ``torch.cuda.empty_cache()`` returned it, without the sleep; each
line then also gives the state and the GB reserved.

SRC is the source tree to import ``repro_torch`` from (``src``, or the
``src`` of another commit unpacked by ``git archive``), so two commits
are compared on one card in turns. Needs a CUDA device.
"""

import json
import sys
import time

import numpy as np


def trace(k):
    rng = np.random.default_rng(1)
    widths = [(256, 128, 64, 384)[r % 4] for r in range(32)] + [1200]
    return [rng.normal(size=(k, w)).astype(np.float32) for w in widths]


def main(src, hold_gb=0.0):
    sys.path.insert(0, src)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.paper_spmm import WORKLOADS
    from repro_torch.core.incrs import InCRS
    from repro_torch.data import datasets
    from repro_torch.serve import engine as E
    from repro_torch.sparse import api

    w = np.random.default_rng(0).standard_normal(
        (6144, 24576), dtype=np.float32) * 0.02
    bound = api.Linear.from_dense(w, api.SparseSpec(
        "bsr", density=0.25, block=128), device="cuda").bound()
    del w
    wl = WORKLOADS["incrs-docword"]
    inc = InCRS.from_crs(datasets.synthesize(wl.dataset, seed=0),
                         wl.section, wl.block)

    def serve(op, panels):
        eng = E.SpMMEngine(op, max_wave_cols=512, device="cuda")
        for i, p in enumerate(panels):
            eng.submit(E.SpMMRequest(i, p))
        eng.run()
        torch.cuda.synchronize()
        return eng.stats_summary()

    for label, op, keys in (("granite bsr", bound, ("bsr_kernel", "bsrsrc")),
                            ("docword incrs", inc, ("expand_kernel",))):
        panels = trace(op.shape[1])
        serve(op, panels)
        for sess in range(6):
            sleep = sess >= 3 and not hold_gb
            state = ("fresh", "fresh", "held", "held", "emptied",
                     "emptied")[sess] if hold_gb else None
            if state == "held" and sess == 2:
                torch.empty(int(hold_gb * 2 ** 30), dtype=torch.uint8,
                            device="cuda")
            if state == "emptied" and sess == 4:
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            serve(op, panels)
            plain_ms = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                sp = serve(op, panels)
                if sleep:
                    torch.cuda.synchronize()
                    time.sleep(0.3)
            kinds = {"kernel": [0, 0.0], "htod": [0, 0.0],
                     "dtoh": [0, 0.0], "other": [0, 0.0]}
            for ev in prof.key_averages():
                if ev.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0))
                key = ev.key.lower()
                kind = ("kernel" if any(k in key for k in keys) else
                        "htod" if "htod" in key else
                        "dtoh" if "dtoh" in key else "other")
                kinds[kind][0] += ev.count
                kinds[kind][1] += us / 1e3
            print(json.dumps({
                "src": src, "operand": label, "session": sess,
                "sleep": sleep, "state": state,
                "reserved_gb": torch.cuda.memory_reserved() / 2 ** 30,
                "waves": sp["waves"],
                "plain_wall_ms": plain_ms,
                "prof_wall_ms": sp["elapsed_s"] * 1e3, "kinds": kinds}),
                flush=True)


if __name__ == "__main__":
    main(sys.argv[1], float(sys.argv[2]) if len(sys.argv) > 2 else 0.0)
