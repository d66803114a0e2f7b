#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

Phases, each printing one JSON line:

1. env     — the card (nvidia-smi name and power limit), torch and CUDA
             versions, and the build of every kernel from ``csrc/`` with
             each kernel's registers and spill bytes from ptxas.
2. kernels — each hand-written InCRS kernel against its plain torch
             version on the card (the five Table II operands at N = 512,
             incrs-docword also at N = 128 and 640, edge operands and a
             skewed one whose first row tile holds most of the
             non-zeros), the three bitwise against each other.
3. serve   — the main path: ``SpMMEngine`` on the five Table II workloads
             at their published sizes, then incrs-docword with each
             explicit variant, every request checked against the float64
             product on the host; then the serving launcher once as a
             subprocess. Launch counters are zeroed just before and read
             just after, and must equal the waves.
4. profile — incrs-docword served twice more: plain for the wall time and
             the host's staging, then under torch.profiler for device time
             by kind (kernel, copies); the idle share of the card. After
             phase 10 the same for docword as bsr and as dense plans and
             for the granite bsr plan.
5. times   — the three InCRS orders' median times over CUDA events on
             each Table II operand at N = 512 (incrs-docword also at 128
             and 640), beside ``torch.sparse.mm`` and the bound of the
             card; at incrs-docword, N = 512, also each plain version and
             the pipelined kernel at other cluster sizes, warp counts and
             block widths (``pipe_geometries``, each bitwise equal to
             expand).
6. spgemm_kernels — the sparse × sparse kernels against their plain
             versions on the card: the eight Table IV operands as A·Aᵀ at
             R = 128 (mesh-docword4 also at R = 32) and edge operands;
             condense + merge and merge bitwise equal to index matching and
             to plain merge, the gather bitwise equal to its plain version
             and its repeat; each of the four kernels' two instances
             bitwise equal to each other.
7. spgemm  — the second path: ``ops.spmm(A, A)`` through every engine, an
             InCRS right-hand side, R = 32, and ``spgemm.spgemm`` on the
             eight Table IV workloads at their published sizes, every C
             checked against the float64 product on the host and every
             call's launches against its engine, each call's wall split
             into host time, device span and wait, and the caching
             allocator's cudaMalloc, cudaFree and retry counts around it.
             Counters are zeroed just before and read just after; the
             second designs' instances must each have run.
   spgemm_alloc — mesh-mks4's and mesh-bates' condense + merge calls in
             turn, the allocator's cache warm and emptied, each call's
             wall, CPU time and allocator counters, and one fresh
             cudaMalloc of bates' R = 32 stripes.
8. spgemm_times — mesh-docword4 at R = 128: each kernel's median time
             beside its plain version, the library call and the bound
             (the gather and merge also in their first designs).
   spgemm_operands — the eight Table IV operands at R = 128, and at R =
             32 where the stripes fit: index matching and condense (R =
             128, docword also at 32), each in the ring instance and the
             general one (the first design), beside torch.sparse.mm, the
             bound and the ring's packing pre-pass alone; merge (ring and
             general, beside stripes.sum(0) and stripes.sum(), a read of
             the same bytes) and the gather (R = 128; tile and general,
             beside A_csr.to_dense(), a fill of the output and a pad of
             the stripes to the output's shape), each with its bound; the
             instance each rule picks.
   spgemm_geometries — the ring at other rows per warp, ring depths and
             (condense) items a CTA, the gather's tile at other sections
             an item (also at mesh-sch), merge's ring at other chunks and
             depths (also at mesh-mks4), each bitwise equal to the rule's;
             each instance's
             CTAs an SM from the occupancy calculator, every persistent
             grid checked to fit one wave.
9. plan_kernels — the BSR and dense kernels against their plain versions
             (and, in f32, float64) on the card: the five Table II
             operands as BSR (blocks 50, 10, 50, 60, 50) at N = 512, the
             granite-34b MLP operand W_up^T (24576 x 6144, block 128,
             density 0.25) in both formats, docword dense, and edge
             operands (split-K, skewed block-rows); granite, docword
             dense and one general-instance edge each also in bf16 (held
             row by row). Every call runs twice, bitwise equal, and names
             the instance and K splits that ran.
10. plan_serve — the third path: ``SpMMEngine(plan_for_operand(...))``
             as bsr and as dense on the five Table II operands at full
             size and the granite operand, each with the mixed-width
             trace of phase 3. Counters are zeroed just before and read
             just after; every wave launches one kernel of its format and
             no other. Then the serving launcher as a subprocess with
             --format bsr and --format dense on the five Table II
             workloads and once with --spmm-swap, checked for its exit
             code, error and launches (two waves each: its printed rate
             measures nothing).
             Then bf16 bsr and dense plans of docword served with bf16
             requests, one launch of the bf16 instance per wave.
11. plan_times — both kernels at the granite operand and at docword,
             N = 512, in f32 and in bf16: median time, plain version,
             library call, bound; the card's SM clock and power while the
             f32 dense kernel and torch.matmul run at granite
             (``plan_clocks``); then the dense instances at other K
             splits, ring depths and (bf16) tile widths
             (``plan_geometries``).
12. train — the fifth path: granite-34b's MLP (W_up 6144 -> 24576, tanh,
             W_down back) trained at full width for 8 AdamW steps on 512
             token rows, once as incrs (density 0.1, section 256) and once
             as bsr (block 128, density 0.25): the packing timed; step 0's
             gradients (live slots) and dL/dh within 1e-4 of a float64
             host oracle; l2's dx kernel on the transposed stripes or
             block lists within 1e-5 of its plain version; each product
             of a step timed alone (the forwards, dx beside its plain
             version and a library call, each dW beside the dense x^T dy);
             then the steps, each split by CUDA events into forward,
             backward and optimizer, with peak memory. Counters are zeroed
             just before the steps and read just after: 3 launches of the
             format's kernel a step and none of another. The loss falls,
             pad slots and zero tiles stay 0.0, the trained l1 is served
             by SpMMEngine within 1e-4 of float64 one launch a wave, and
             the training example runs as a subprocess.
13. lifecycle — after each format's phase train, on its trained student
             (the sixth path): an SpMMEngine serves l1 (W_up) with the
             first half of phase 3's trace; the prune callback re-prunes
             l1 at one due step (incrs to density 0.05, bsr to block
             density 0.125), timed on the host; one wave is launched, the
             repacked l1 is hot-swapped in (``swap_pattern``, timed) and
             the rest of the trace served: every request within 1e-4 of
             float64 of the weight in force when its wave launched, one
             launch a wave, counters zeroed just before. Then step 0's
             gradients on the new live set against float64, 2 AdamW steps
             on the repacked moments (3 launches a step, no other kernel,
             split forward / backward / optimizer), survivors carried over
             and pruned slots gone, pad slots and zero tiles 0.0, latency
             before and after the swap (and the served operand's kernel
             alone on a 512-column panel, before and after), peak memory;
             after both formats, the reprune example as a subprocess.
14. crs_plan — the seventh path: granite-34b's W_up^T (24576 x 6144,
             density 0.1) planned once by ``plan_for_operand`` as ``crs``
             (R = 128), times B^T = top-5 % activations (307 of 6,144 per
             row, 512 rows): index matching and condense + merge (a crs and
             an InCRS B^T), each called twice (RHS prep, then a memo hit),
             C within 1e-4 of float64 on the host, condense + merge bitwise
             equal to index matching, counters zeroed just before; the
             plan's and the bind's host time; each kernel on the plan's
             operands against its plain version, timed beside its bound and
             a library call. Then mesh-docword4 at R = 128 and 32: a bound
             plan's calls beside ops.spmm(A, A) through the same engine,
             bitwise equal.
15. lm_kernels — the flash-attention kernels against their plain version
             on the card, f32 (the FMA kernel) and bf16 (the tensor-core
             kernel), each call checked to launch its type's kernel:
             granite-34b's prefill wave (B = 2,
             S = 8192, one KV head, 48 query heads, hd 128), a mixtral
             shape (window 4096, KV 8, G 4), a recurrentgemma shape (soft
             cap 30, window 2048, hd 256) and edge shapes. bf16 is held
             on every query row; at granite's wave the same check must
             reject a planted fault (key tile 0 dropped past row 4096).
16. lm_serve — the fourth path: granite-34b at full width, depth cut to
             4 layers, served by ``ServeEngine``: 2 requests of 8,192
             tokens (one wave through the kernel, one launch per layer)
             and 4 of 512 (the dense branch, no launch), counters zeroed
             just before; the long wave profiled for the idle share; the
             f32 decode logits against a teacher-forced prefill; the
             launcher as a subprocess. Device time is sorted by kernel
             symbol: the flash kernels by the names the wrapper exports.
17. lm_times — the bf16 kernel at granite's wave: median time, TFLOP/s
             and share of the bound, beside the f32 kernel on the same
             values, the plain version and scaled_dot_product_attention.

Then the card's line, the ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. Any failed check raises. Without a CUDA
device, or without the rest of the repository, it exits non-zero and
prints no result.
"""
import json
import os
import re
import statistics
import subprocess
import sys
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

KERNELS = (  # (entry point, variant, Pallas kernel it replaces)
    ("incrs_spmm", "expand", "src/repro/kernels/incrs_spmm.py:111"),
    ("incrs_spmm_reuse", "reuse", "src/repro/kernels/incrs_spmm.py:178"),
    ("incrs_spmm_pipelined", "pipelined",
     "src/repro/kernels/incrs_spmm.py:252"),
)
RAN_BY = {"auto": "incrs_spmm", **{v: k for k, v, _ in KERNELS}}
SOURCE = "src/repro_torch/kernels/csrc/incrs_spmm.cu"
TABLE2 = ("incrs-docword", "incrs-amazon", "incrs-belcastro", "incrs-norris",
          "incrs-mks")
TABLE4 = ("mesh-amazon4", "mesh-docword4", "mesh-mks4", "mesh-norris4",
          "mesh-arenas", "mesh-bates", "mesh-gleich", "mesh-sch")
SPGEMM_KERNELS = (  # (name, source, Pallas kernel it replaces)
    ("incrs_gather", "src/repro_torch/kernels/csrc/incrs_gather.cu",
     "src/repro/kernels/incrs_gather.py:28"),
    ("index_match_spmm", "src/repro_torch/kernels/csrc/index_match.cu",
     "src/repro/kernels/index_match_spmm.py:48"),
    ("spgemm_condense", "src/repro_torch/kernels/csrc/index_match.cu",
     "src/repro/spgemm/kernels.py:48"),
    ("spgemm_merge", "src/repro_torch/kernels/csrc/index_match.cu",
     "src/repro/spgemm/kernels.py:97"),
)
ENGINE_LAUNCHES = {
    "reference": {"index_match_spmm": 1},
    "auto": {"index_match_spmm": 1},
    "condense_merge": {"spgemm_condense": 1, "spgemm_merge": 1},
    "densify": {"incrs_gather": 1, "incrs_spmm": 1},
}
STRIPES_MAX_BYTES = 8e9  # condense_merge at R = 32 only below this
# H100 SXM: HBM rate, and the f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12   # H100 SXM bf16 tensor-core peak, dense
KERNEL_TOL = 1e-5        # max|kernel - plain| <= KERNEL_TOL * max|C|
SERVE_TOL = 1e-4         # max|served - float64 host| <= SERVE_TOL * max|C|
BF16_TOL = 1e-2          # bf16: per row, max|kernel - plain| <= BF16_TOL *
                         # that row's max|C| (flash_attention's rule)
PLAN_KERNELS = (  # (name, source, Pallas kernel it replaces)
    ("bsr_spmm", "src/repro_torch/kernels/csrc/bsr_spmm.cu",
     "src/repro/kernels/bsr_spmm.py:37"),
    ("dense_mm", "src/repro_torch/kernels/csrc/dense_mm.cu",
     "src/repro/kernels/dense_mm.py:21"),
)
# Table II operands as BSR: the largest block side <= 64 dividing M and K.
TABLE2_BLOCK = {"incrs-amazon": 50, "incrs-belcastro": 10,
                "incrs-docword": 50, "incrs-norris": 60, "incrs-mks": 50}
# The granite-34b dense GELU MLP (src/repro/configs/granite_34b.py: d_model
# 6144, d_ff 24576) pruned by the repo's BlockSparsity default (block 128,
# density 0.25, src/repro/models/config.py); A = W_up^T, W_up seeded normal
# with scale 0.02.
GRANITE = {"d_model": 6144, "d_ff": 24576, "block": 128, "density": 0.25,
           "scale": 0.02, "seed": 0}
GRANITE_NAME = "granite-34b W_up^T"
# The plan-path engine runs profiled after the counted run (phase 4).
PROFILED = {("incrs-docword", "bsr"), ("incrs-docword", "dense"),
            (GRANITE_NAME, "bsr")}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ----------------------------------------------------------------------
def phase_env(torch, build):
    smi = smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = [dict(source=name, **k) for name in build.sources()
             for k in ptxas_kernels(build.build_log(name))]
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "build_s": build_s, "sources": build.sources(), "ptxas": ptxas})


def _short_name(sym: str) -> str:
    """``reuse_kernel<128>`` from an Itanium-mangled kernel symbol in an
    (anonymous) namespace."""
    i = sym.find("_ZN")
    if i < 0:
        return sym
    i += 3
    names = []
    while i < len(sym) and sym[i].isdigit():
        j = i
        while sym[j].isdigit():
            j += 1
        names.append(sym[j:j + int(sym[i:j])])
        i = j + int(sym[i:j])
    targs = re.match(r"I((?:L[ib]\d+E)+)E", sym[i:])
    args = re.findall(r"L[ib](\d+)E", targs.group(1)) if targs else []
    return names[-1] + (f"<{','.join(args)}>" if args else "")


def ptxas_kernels(log: str) -> list:
    """Registers and spill bytes of each kernel in a ``-Xptxas=-v`` log."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = {"kernel": _short_name(m.group(1)), "registers": None,
                   "spill_stores": None, "spill_loads": None}
            out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int,
                                                               m.groups())
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur["registers"] = int(m.group(1))
    return out


def _edge_operands():
    """Small operands that reach each masked edge of the kernels."""
    rng = np.random.default_rng(7)

    def sparse(m, k, d):
        a = rng.uniform(0.5, 1.5, size=(m, k)).astype(np.float32)
        a[rng.random(size=(m, k)) >= d] = 0.0
        return a

    ragged = sparse(203, 1000, 0.05)              # M not a multiple of 8
    empty = sparse(64, 777, 0.05)
    empty[3] = 0.0
    empty[10:20] = 0.0                            # empty rows
    single = np.zeros((50, 1024), np.float32)     # smax = 1
    for r in range(50):
        for s in range(0, 4, 1 + r % 2):
            single[r, s * 256 + rng.integers(256)] = 1.0 + r
    dense_sec = sparse(40, 600, 0.03)
    dense_sec[:, 256:512] = rng.uniform(0.5, 1.5, size=(40, 256))
    k_ragged = sparse(90, 300, 0.1)               # K not a multiple of S
    skewed = sparse(600, 2048, 0.01)              # one row tile holds most
    skewed[:48] = sparse(48, 2048, 0.5)           # of the non-zeros
    return {"m_ragged": ragged, "empty_rows": empty, "smax_1": single,
            "dense_section": dense_sec, "k_ragged": k_ragged,
            "skewed": skewed}


def _compare(torch, K, idx, val, b, *, section, bm, bn, label):
    """Each kernel against its plain version, and the three bitwise."""
    outs = {}
    errs = {}
    for name, _, _ in KERNELS:
        before = K.LAUNCHES[name]
        out = getattr(K, name)(idx, val, b, section=section, bm=bm, bn=bn)
        torch.cuda.synchronize()
        check(K.LAUNCHES[name] == before + 1, f"{name} counted its launch")
        ref = K.plain(name, idx, val, b, section=section, bm=bm, bn=bn)
        scale = max(float(ref.abs().max()), 1e-30)
        err = float((out - ref).abs().max())
        check(bool(torch.isfinite(out).all()), f"{name} finite on {label}")
        check(err <= KERNEL_TOL * scale,
              f"{name} on {label}: max|err| {err} > {KERNEL_TOL} * {scale}")
        outs[name], errs[name] = out, err
    first = outs[KERNELS[0][0]]
    for name, _, _ in KERNELS[1:]:
        check(torch.equal(outs[name], first),
              f"{name} bitwise equal to incrs_spmm on {label}")
    return errs


def phase_kernels(torch, K, ops, InCRS, table2):
    results = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs_512 = None
    for wl_name, inc in table2.items():
        prep = ops.prepare_incrs(inc, device="cuda")
        kp = prep.n_sections * prep.section
        m, k = prep.shape
        for n in (128, 512, 640) if wl_name == "incrs-docword" else (512,):
            bn = ops.default_bn(n)
            np_ = -(-n // bn) * bn
            b = torch.zeros(kp, np_, device="cuda")
            b[:k, :n] = torch.randn(k, n, generator=gen, device="cuda")
            errs = _compare(torch, K, prep.idx, prep.val, b,
                            section=prep.section, bm=128, bn=bn,
                            label=f"{wl_name} N={n}")
            if wl_name == "incrs-docword" and n == 512:
                errs_512 = errs
            results.append({"operand": wl_name, "shape": [m, k],
                             "stripes": list(prep.idx.shape), "n": n,
                             "bn": bn, "max_abs_err": errs})
    for label, dense in _edge_operands().items():
        inc = InCRS.from_dense(dense)
        ep = ops.prepare_incrs(inc, pad_rows_to=1, device="cuda")
        kp = ep.n_sections * ep.section
        for n in (128, 384):
            b = torch.zeros(kp, n, device="cuda")
            b[:dense.shape[1]] = torch.randn(dense.shape[1], n,
                                             generator=gen, device="cuda")
            errs = _compare(torch, K, ep.idx, ep.val, b, section=ep.section,
                            bm=128, bn=n, label=f"{label} N={n}")
            got = ops.spmm(inc, b[:dense.shape[1]], device="cuda").cpu()
            want = dense.astype(np.float64) @ \
                b[:dense.shape[1]].cpu().numpy().astype(np.float64)
            scale = max(float(np.abs(want).max()), 1e-30)
            check(float(np.abs(got.numpy() - want).max()) <= SERVE_TOL * scale,
                  f"ops.spmm on {label} N={n} against float64")
            results.append({"operand": label, "shape": list(dense.shape),
                            "smax": int(ep.idx.shape[2]), "n": n,
                            "max_abs_err": errs})
    emit({"phase": "kernels", "names": [k[0] for k in KERNELS],
          "tolerance": f"max|kernel-plain| <= {KERNEL_TOL} * max|C|",
          "bitwise_across_kernels": True, "checks": results})
    return errs_512


def _trace(k, seed):
    rng = np.random.default_rng(seed)
    widths = [(256, 128, 64, 384)[r % 4] for r in range(32)] + [1200]
    return [rng.normal(size=(k, w)).astype(np.float32) for w in widths]


def phase_serve(K, engine_mod, table2):
    K.reset_launches()
    runs = [(name, "auto") for name in TABLE2] + \
        [("incrs-docword", v) for _, v, _ in KERNELS]
    traces = {}
    for wl_name, variant in runs:
        inc = table2[wl_name]
        crs = inc.crs
        if wl_name not in traces:        # one workload's reference at a time
            panels = _trace(crs.shape[1], seed=1)
            traces = {wl_name: (panels, crs.to_dense().astype(np.float64) @
                                np.concatenate(panels, axis=1).astype(
                                    np.float64))}
        panels, ref = traces[wl_name]
        before = dict(K.LAUNCHES)
        eng = engine_mod.SpMMEngine(inc, max_wave_cols=512, variant=variant,
                                    device="cuda")
        reqs = [engine_mod.SpMMRequest(i, p) for i, p in enumerate(panels)]
        for r in reqs:
            eng.submit(r)
        done = eng.run()
        check(len(done) == len(reqs) and all(r.done for r in reqs),
              f"{wl_name}/{variant}: every request served")
        off, worst = 0, 0.0
        for r in reqs:
            want = ref[:, off:off + r.b.shape[1]]
            off += r.b.shape[1]
            check(r.out.shape == want.shape and np.isfinite(r.out).all(),
                  f"{wl_name}/{variant} request {r.rid} finite, right shape")
            err = float(np.abs(r.out - want).max())
            cmax = max(float(np.abs(want).max()), 1e-30)
            check(err <= SERVE_TOL * cmax,
                  f"{wl_name}/{variant} request {r.rid}: {err} > "
                  f"{SERVE_TOL} * {cmax}")
            worst = max(worst, err / cmax)
        delta = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
        ran = RAN_BY[variant]
        check(delta[ran] == eng.stats["waves"] and
              sum(delta.values()) == delta[ran],
              f"{wl_name}/{variant}: launches {delta} equal the "
              f"{eng.stats['waves']} waves of {ran}")
        s = eng.stats_summary()
        emit({"phase": "serve", "workload": wl_name, "variant": variant,
              "a_shape": list(crs.shape), "nnz": crs.nnz,
              "stripes": list(eng.prep.idx.shape),
              "requests": s["requests"], "waves": s["waves"],
              "split_requests": int(eng.stats["split_requests"]),
              "launches": delta, "requests_per_s": s["requests_per_s"],
              "latency_ms_p50": s["latency_ms"]["p50"],
              "latency_ms_p99": s["latency_ms"]["p99"],
              "wave_ms_p50": s["wave_ms"]["p50"],
              "prep_overlap_fraction": s["prep_overlap_fraction"],
              "max_rel_err": worst})
    launches = dict(K.LAUNCHES)
    check(all(v > 0 for v in launches.values()),
          f"every kernel ran on the main path: {launches}")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--spmm",
           "--workload", "incrs-docword", "--scale", "1.0",
           "--device", "cuda"]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    emit({"phase": "serve_launcher", "cmd": " ".join(cmd[1:]),
          "rc": proc.returncode, "stdout": proc.stdout.strip()[-2000:],
          "stderr": proc.stderr.strip()[-2000:]})
    check(proc.returncode == 0, "launcher exited 0")
    return launches


def phase_profile(torch, engine_mod, operand, k, *, workload="incrs-docword",
                  fmt="incrs", kernel_keys=("expand_kernel",)):
    """Two more serve runs of ``operand`` (an InCRS or a bound plan, K
    columns) after the counted main path: one plain, for the wall time and
    the host's share of it, then the same run under torch.profiler for the
    card's busy time by kind. The idle share is taken against the plain
    run, since the profiler slows the host. A kernel is the format's when
    its symbol holds one of ``kernel_keys``; the run fails if none did."""
    from torch.profiler import ProfilerActivity, profile
    panels = _trace(k, seed=1)

    def serve():
        eng = engine_mod.SpMMEngine(operand, max_wave_cols=512,
                                    device="cuda")
        for i, p in enumerate(panels):
            eng.submit(engine_mod.SpMMRequest(i, p))
        eng.run()
        torch.cuda.synchronize()
        return eng.stats_summary()

    s = serve()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s_prof = serve()
    kernel_kind = f"kernel_{fmt}"
    by_kind = {kernel_kind: 0.0, "memcpy_h2d": 0.0, "memcpy_d2h": 0.0,
               "other": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue            # host ops: their device time is counted
        us = getattr(ev, "self_device_time_total",  # on the device events
                     getattr(ev, "self_cuda_time_total", 0.0))
        key = ev.key.lower()
        kind = (kernel_kind if any(k in key for k in kernel_keys) else
                "memcpy_h2d" if "htod" in key else
                "memcpy_d2h" if "dtoh" in key else "other")
        by_kind[kind] += us / 1e3
    check(by_kind[kernel_kind] > 0, f"profile of {workload} {fmt}: no device "
          f"time in a kernel whose symbol holds {kernel_keys}")
    wall_ms = s["elapsed_s"] * 1e3
    busy_ms = sum(by_kind.values())
    emit({"phase": "profile", "workload": workload, "format": fmt,
          "variant": "auto", "waves": s["waves"], "wall_ms": wall_ms,
          "wall_ms_profiled": s_prof["elapsed_s"] * 1e3,
          "device_ms_by_kind": by_kind, "device_busy_ms": busy_ms,
          "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms
          else "not measured",
          "host_staging_ms": s["prep_s_total"] * 1e3,
          "host_staging_hidden_ms": s["prep_s_hidden"] * 1e3,
          "wave_ms_sum": s["wave_ms"]["mean"] * s["waves"],
          "prep_overlap_fraction": s["prep_overlap_fraction"],
          "requests_per_s": s["requests_per_s"]})


def _time_ms(torch, fn, flush, reps=30, lead=1):
    """Median ms of ``fn`` over CUDA events, L2 flushed before each run
    (``lead`` times: more work queued ahead of a short kernel whose
    wrapper takes the host longer than one flush takes the card)."""
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        for _ in range(lead):
            flush.zero_()   # evicts L2, and keeps the card busy while the
        s = torch.cuda.Event(enable_timing=True)   # host enqueues fn
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _incrs_bound(torch, prep, n):
    """The least time of C = A @ B at N columns: each input read once (idx
    in full, since the pad slots must be read to be skipped; val of the
    live slots; the rows of B that a live slot references), C's M rows
    written once; 2 flops per live slot and column at the f32 rate
    outside the tensor cores. Returns (bytes, flops, ms by bytes, ms by
    operations, live slots)."""
    idx = prep.idx
    live = (idx >= 0) & (idx < prep.section)
    n_live = int(live.sum())
    rows_b = torch.unique((idx.long() + torch.arange(
        prep.n_sections, device=idx.device).view(1, -1, 1) *
        prep.section)[live])
    nbytes = idx.numel() * 4 + n_live * 4 + rows_b.numel() * n * 4 + \
        prep.shape[0] * n * 4
    flops = 2 * n_live * n
    return (nbytes, flops, nbytes / HBM_BYTES_PER_S * 1e3,
            flops / F32_FLOP_PER_S * 1e3, n_live)


# Where the three orders are timed: every Table II operand at N = 512,
# incrs-docword also at 128 and 640.
TIME_CASES = [(name, 512) for name in TABLE2] + \
    [("incrs-docword", 128), ("incrs-docword", 640)]
# The pipelined geometries timed beside the one the wrapper picks
# (incrs-docword, N = 512), as changes to pipelined_geometry's arguments:
# no cluster (the design without multicast) and a cluster of 4; 16 and 31
# consumer warps (one row each); one column per lane (32 KB ring stages),
# and that with 8 warps, two CTAs an SM.
PIPE_SWEEP = [{}, {"cluster": 1}, {"cluster": 4}, {"warps": 16},
              {"warps": 31}, {"cols_per_lane": 1},
              {"cols_per_lane": 1, "warps": 8}]


def _pipe_sweep(torch, K, prep, b, n, flush, want):
    """The pipelined kernel at each geometry of PIPE_SWEEP, each run
    bitwise equal to expand."""
    out = []
    mp, _, smax = prep.idx.shape
    for change in PIPE_SWEEP:
        try:
            g = K.pipelined_geometry(mp, n, smax, prep.section, **change)
        except ValueError:          # does not fit one SM's shared memory
            continue

        def fn(g=g):
            return K._launch("incrs_spmm_pipelined", prep.idx, prep.val, b,
                             prep.section, geometry=g)
        check(torch.equal(fn(), want), f"pipelined at {g} equal to expand")
        out.append({**g._asdict(), "ms": _time_ms(torch, fn, flush)})
    emit({"phase": "pipe_geometries", "workload": "incrs-docword", "n": n,
          "picked": K.launch_geometry("incrs_spmm_pipelined", n, smax,
                                      prep.section, m=mp)._asdict(),
          "geometries": out})


def phase_times(torch, K, ops, table2, errs_512, launches):
    flush = torch.empty(64 * 2 ** 20, device="cuda")     # 256 MB
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for wl_name, n in TIME_CASES:
        inc = table2[wl_name]
        prep = ops.prepare_incrs(inc, device="cuda")
        kp = prep.n_sections * prep.section
        b = torch.zeros(kp, n, device="cuda")
        b[:inc.shape[1]] = torch.randn(inc.shape[1], n, generator=gen,
                                       device="cuda")
        crs = inc.crs
        a_csr = torch.sparse_csr_tensor(
            torch.from_numpy(crs.row_ptr), torch.from_numpy(
                crs.col_idx.astype(np.int64)),
            torch.from_numpy(crs.values), size=crs.shape,
            check_invariants=True).to("cuda")
        b_k = b[:inc.shape[1]].contiguous()
        library_ms = _time_ms(torch, lambda: torch.sparse.mm(a_csr, b_k),
                              flush)
        nbytes, flops, t_bytes, t_ops, n_live = _incrs_bound(torch, prep, n)
        bound_ms = max(t_bytes, t_ops)
        args = (prep.idx, prep.val, b)
        kw = dict(section=prep.section, bm=128, bn=n)
        ms = {}
        for name, _, _ in KERNELS:
            fn = getattr(K, name)
            ms[name] = _time_ms(torch, lambda: fn(*args, **kw), flush)
        mp, n_sec, _ = prep.idx.shape
        emit({"phase": "times", "workload": wl_name, "n": n,
              "stripes": list(prep.idx.shape),
              "live_per_row_section": n_live / (mp * n_sec),
              "bytes": nbytes, "flops": flops, "bound_bytes_ms": t_bytes,
              "bound_ops_ms": t_ops, "bound_ms": bound_ms,
              "library": "torch.sparse.mm (CSR)", "library_ms": library_ms,
              "ms": ms})
        if (wl_name, n) != ("incrs-docword", 512):
            continue
        _pipe_sweep(torch, K, prep, b, n, flush, K.incrs_spmm(*args, **kw))
        for name, _, replaces in KERNELS:
            fn = getattr(K, name)
            ms_warm = _time_ms(torch, lambda: fn(*args, **kw),
                               torch.empty(0, device="cuda"))
            plain_ms = _time_ms(torch, lambda: K.plain(name, *args, **kw),
                                flush, reps=20)
            rows.append({"name": name, "route": "cuda", "source": SOURCE,
                         "replaces": replaces, "launches": launches[name],
                         "max_abs_err": errs_512[name], "ms": ms[name],
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": "bytes" if t_bytes >= t_ops
                         else "operations",
                         "library_ms": library_ms, "ms_l2_warm": ms_warm})
    return rows


# ----------------------------------------------------------------------
# The sparse × sparse path: C = A @ Bt.T through index matching,
# condense + merge, and densify (gather, then the fused InCRS SpMM).
def _counters(P):
    return {**P.K.LAUNCHES, **P.G.LAUNCHES, **P.IM.LAUNCHES, **P.SK.LAUNCHES}


def _reset_counters(P):
    for mod in (P.K, P.G, P.IM, P.SK):
        mod.reset_launches()


def _instances(P):
    return {**P.IM.INSTANCE_LAUNCHES, **P.SK.MERGE_INSTANCE_LAUNCHES,
            **P.G.INSTANCE_LAUNCHES}


# The instances of the second designs, each of which must run on the
# spgemm path; and the caching allocator's counters read around each call
# of that path (cudaMalloc calls, cudaFree calls, retries after a failed
# cudaMalloc that first frees the cache).
NEW_INSTANCES = ("index_match_spmm/ring", "spgemm_condense/ring",
                 "spgemm_merge/ring", "incrs_gather/tile")
ALLOC_STATS = ("num_device_alloc", "num_device_free", "num_alloc_retries",
               "num_sync_all_streams")


def _spgemm_edges():
    """(A, Bt) dense pairs that reach each masked edge of the kernels."""
    rng = np.random.default_rng(17)

    def sparse(m, k, d):
        a = rng.uniform(-1.5, 1.5, size=(m, k)).astype(np.float32)
        a[rng.random(size=(m, k)) >= d] = 0.0
        return a

    empty = sparse(150, 700, 0.05)
    empty[3] = 0.0
    empty[40:60] = 0.0                            # empty rows
    single = np.zeros((100, 512), np.float32)     # rmax = 1
    for r in range(100):
        for t in range(0, 4, 1 + r % 2):
            single[r, t * 128 + rng.integers(128)] = 1.0 + r
    full = sparse(90, 384, 0.03)
    full[::4, 128:256] = rng.uniform(0.5, 1.5, size=(23, 128))  # rmax = R
    return {"all_zero": (np.zeros((64, 300), np.float32),
                         sparse(40, 300, 0.1)),
            "empty_rows": (empty, empty),
            "rmax_1": (single, single),
            "full_window": (full, full),
            "k_ragged": (sparse(130, 1000, 0.04), sparse(130, 1000, 0.04)),
            "mn_ragged_a_ne_b": (sparse(203, 640, 0.06),
                                 sparse(77, 640, 0.08))}


def _match_geo(P, ai, bi, rounds, kernel, **kw):
    m, n_rounds, rmax_a = ai.shape
    return P.IM.match_geometry(m, bi.shape[0], n_rounds, rmax_a,
                               bi.shape[2], rounds, kernel, **kw)


def _check_match(torch, P, ai, av, bi, bv, *, rounds, bm, label):
    """Index matching against its plain version, its repeat and the other
    instance (``match_geometry``: the ring and the general kernel);
    condense against the plain per-round partials and its repeat; merge
    against plain merge and condense + merge against index matching, bit
    for bit. Frees the stripes. Returns the errors and the instances."""
    kw = dict(rounds=rounds, bm=bm, bn=bm)
    geo = _match_geo(P, ai, bi, rounds, "index_match_spmm")
    other = _match_geo(P, ai, bi, rounds, "index_match_spmm",
                       instance=({"ring": "general", "general": "ring"}
                                 [geo.instance]))
    before = _counters(P)
    fused = P.IM.index_match_spmm(ai, av, bi, bv, **kw)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in _counters(P).items()}
    again = P.IM.index_match_spmm(ai, av, bi, bv, **kw)
    cross = P.IM.index_match_spmm(ai, av, bi, bv, geometry=other, **kw)
    torch.cuda.synchronize()
    check(torch.equal(again, fused),
          f"index_match bitwise equal to its repeat on {label}")
    check(torch.equal(cross, fused), f"index_match {geo.instance} bitwise "
          f"equal to {other.instance} on {label}")
    del again, cross
    ref = P.IM.plain(ai, av, bi, bv, **kw)
    scale = max(float(ref.abs().max()), 1e-30)
    err7 = float((fused - ref).abs().max())
    check(bool(torch.isfinite(fused).all()), f"index_match finite on {label}")
    check(err7 <= KERNEL_TOL * scale, f"index_match on {label}: max|err| "
          f"{err7} > {KERNEL_TOL} * {scale}")
    del ref
    before_cm = _counters(P)
    stripes = P.SK.spgemm_condense(ai, av, bi, bv, **kw)
    merged = P.SK.spgemm_merge(stripes, bm=bm, bn=bm)
    torch.cuda.synchronize()
    moved.update({k: v - before_cm[k] for k, v in _counters(P).items()
                  if k != "index_match_spmm"})
    check(torch.equal(merged, fused),
          f"condense + merge bitwise equal to index_match on {label}")
    check(torch.equal(P.SK.spgemm_condense(ai, av, bi, bv, **kw), stripes),
          f"condense bitwise equal to its repeat on {label}")
    check(torch.equal(P.SK.plain_merge(stripes, bm=bm, bn=bm), merged),
          f"merge bitwise equal to its plain version on {label}")
    n_rounds, sm, sn = stripes.shape
    merge_geo = P.SK.merge_geometry(sm * sn, n_rounds)
    general = P.SK.merge_geometry(sm * sn, n_rounds, instance="general")
    check(torch.equal(P.SK.spgemm_merge(stripes, bm=bm, bn=bm,
                                        geometry=general), merged),
          f"merge {merge_geo.instance} bitwise equal to general on {label}")
    err8 = 0.0
    for t in range(stripes.shape[0]):
        part = P.IM.round_partial(ai, av, bi, bv, t, rounds)
        err8 = max(err8, float((stripes[t] - part).abs().max()))
    check(err8 <= KERNEL_TOL * scale, f"condense on {label}: max|err| "
          f"{err8} > {KERNEL_TOL} * {scale}")
    check(all(moved[k] == 1 for k in ("index_match_spmm", "spgemm_condense",
                                      "spgemm_merge")),
          f"index_match, condense and merge counted their launch on {label}")
    del stripes, merged
    cond = _match_geo(P, ai, bi, rounds, "spgemm_condense")
    return ({"index_match_spmm": err7, "spgemm_condense": err8,
             "spgemm_merge": 0.0},
            {"index_match_spmm": geo.instance,
             "spgemm_condense": cond.instance,
             "spgemm_merge": merge_geo.instance})


def _check_gather(torch, P, inc, label):
    """The gather against its plain version and its repeat, and the
    instance the rule picks against the other (the first design), bit for
    bit. Returns the error and the instance."""
    prep = P.ops.prepare_incrs(inc, pad_rows_to=8, device="cuda")
    geo = P.G.gather_geometry(*prep.idx.shape, prep.section)
    other = P.G.gather_geometry(*prep.idx.shape, prep.section,
                                instance="general")
    before = P.G.LAUNCHES["incrs_gather"]
    out = P.G.incrs_gather(prep.idx, prep.val, section=prep.section, bm=8)
    torch.cuda.synchronize()
    check(P.G.LAUNCHES["incrs_gather"] == before + 1,
          f"incrs_gather counted its launch on {label}")
    ref = P.G.plain(prep.idx, prep.val, section=prep.section, bm=8)
    check(torch.equal(out, ref),
          f"incrs_gather bitwise equal to its plain version on {label}")
    again = P.G.incrs_gather(prep.idx, prep.val, section=prep.section, bm=8)
    first = P.G.incrs_gather(prep.idx, prep.val, section=prep.section, bm=8,
                             geometry=other)
    check(torch.equal(again, out),
          f"incrs_gather bitwise equal to its repeat on {label}")
    check(torch.equal(first, out), f"incrs_gather {geo.instance} bitwise "
          f"equal to {other.instance} on {label}")
    return float((out - ref).abs().max()), geo.instance


def phase_spgemm_kernels(torch, P, table4):
    results = []
    errs_docword = None
    for wl_name, crs in table4.items():
        for rounds in (128, 32) if wl_name == "mesh-docword4" else (128,):
            ai, av = P.ops.prep_rounds(crs, rounds, device="cuda")
            bi, bv = P.ops.prep_rounds(crs, rounds, device="cuda")
            errs, inst = _check_match(torch, P, ai, av, bi, bv,
                                      rounds=rounds, bm=128,
                                      label=f"{wl_name} R={rounds}")
            if wl_name == "mesh-docword4" and rounds == 128:
                errs_docword = errs
            if rounds == 128:
                errs["incrs_gather"], inst["incrs_gather"] = _check_gather(
                    torch, P, P.InCRS.from_crs(crs), wl_name)
            results.append({"operand": wl_name, "rounds": rounds,
                            "prep": list(ai.shape), "instances": inst,
                            "max_abs_err": errs})
            del ai, av, bi, bv
    for label, (a, bt) in _spgemm_edges().items():
        ca, cb = P.CRS.from_dense(a), P.CRS.from_dense(bt)
        ai, av = P.ops.prep_rounds(ca, 128, pad_rows_to=8, device="cuda")
        bi, bv = P.ops.prep_rounds(cb, 128, pad_rows_to=8, device="cuda")
        ai, av, bi, bv = P.ops.pad_common_rmax(ai, av, bi, bv)
        errs, inst = _check_match(torch, P, ai, av, bi, bv, rounds=128,
                                  bm=8, label=label)
        errs["incrs_gather"], inst["incrs_gather"] = _check_gather(
            torch, P, P.InCRS.from_dense(a), label)
        results.append({"operand": label, "a": list(a.shape),
                        "bt": list(bt.shape), "prep": list(ai.shape),
                        "instances": inst, "max_abs_err": errs})
    emit({"phase": "spgemm_kernels",
          "tolerance": f"max|kernel-plain| <= {KERNEL_TOL} * max|C|; "
                       f"merge, condense+merge, the two instances of index "
                       f"matching, of merge and of the gather, every "
                       f"repeat and the gather bitwise",
          "checks": results})
    return errs_docword


def _oracle(torch, crs):
    """float64 C = A @ A.T on the host (scipy.sparse), moved to the card
    for the comparisons."""
    import scipy.sparse as sp
    a = sp.csr_matrix((crs.values.astype(np.float64), crs.col_idx,
                       crs.row_ptr), shape=crs.shape)
    return torch.from_numpy((a @ a.T).toarray()).to("cuda")


def _prep_shape(ops, crs, rounds, pad=128):
    """The shape ``ops.prep_rounds`` gives, without prepping."""
    counts = ops.round_groups(crs, rounds)[1]
    return [-(-crs.shape[0] // pad) * pad, counts.shape[1],
            max(1, int(counts.max(initial=0)))]


def _matched_pairs(crs):
    """Products of C = A @ A.T: sum over columns of (non-zeros in it)^2."""
    c = np.bincount(crs.col_idx, minlength=crs.shape[1]).astype(np.int64)
    return int((c * c).sum())


def phase_spgemm(torch, P, table4):
    """The path, driven with every counter at 0 just before it."""
    _reset_counters(P)
    for wl_name, crs in table4.items():
        ref = _oracle(torch, crs)
        scale = float(ref.abs().max())
        m = crs.shape[0]
        pairs = _matched_pairs(crs)
        calls = [(v, 128, "ops.spmm") for v in
                 ("reference", "condense_merge", "densify", "auto")]
        calls += [("auto", 128, "ops.spmm(InCRS rhs)"),
                  ("reference", 32, "ops.spmm")]
        mp, n_rounds, _ = _prep_shape(P.ops, crs, 32)
        if 4 * n_rounds * mp * mp < STRIPES_MAX_BYTES:
            calls.append(("condense_merge", 32, "ops.spmm"))
        calls.append(("condense_merge", 128, "spgemm.spgemm"))
        for variant, rounds, entry in calls:
            before = _counters(P)
            before_inst = _instances(P)
            mem0 = torch.cuda.memory_stats()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            cpu0 = time.process_time()
            t0 = time.perf_counter()
            ev0.record()
            if entry == "spgemm.spgemm":
                out, est = P.spgemm.spgemm(crs, crs, rounds=rounds)
            elif entry == "ops.spmm(InCRS rhs)":
                out = P.ops.spmm(crs, P.InCRS.from_crs(crs), rounds=rounds)
            else:
                out = P.ops.spmm(crs, crs, variant=variant, rounds=rounds,
                                 device="cuda")
            ev1.record()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            cpu_ms = (time.process_time() - cpu0) * 1e3
            wall_ms = (t2 - t0) * 1e3
            mem1 = torch.cuda.memory_stats()
            moved = {k: v - before[k] for k, v in _counters(P).items()
                     if v != before[k]}
            inst = {k: v - before_inst[k]
                    for k, v in _instances(P).items()
                    if v != before_inst[k]}
            check(moved == ENGINE_LAUNCHES[variant],
                  f"{wl_name} {entry} {variant} R={rounds}: launches {moved}"
                  f" are {ENGINE_LAUNCHES[variant]}")
            line = {"phase": "spgemm", "workload": wl_name, "entry": entry,
                    "engine": variant, "rounds": rounds,
                    "shape": [m, m], "nnz": crs.nnz, "matched_pairs": pairs,
                    "prep": _prep_shape(P.ops, crs, rounds), "launches": moved,
                    "instances": inst, "wall_ms": wall_ms,
                    # the wall split: the host until the call returned
                    # (its own waits on the card included), the card from
                    # before the call to its last launch's end, the host's
                    # wait for the card after the return, and the CPU time
                    # the process got (far under the wall: it was not
                    # running)
                    "host_ms": (t1 - t0) * 1e3,
                    "device_span_ms": ev0.elapsed_time(ev1),
                    "sync_wait_ms": (t2 - t1) * 1e3, "cpu_ms": cpu_ms,
                    "alloc": {k: mem1.get(k, 0) - mem0.get(k, 0) for k in
                              ALLOC_STATS}}
            if entry == "spgemm.spgemm":
                sparse_out = est < P.spgemm.SPARSE_OUTPUT_THRESHOLD
                check(isinstance(out, P.CRS) == sparse_out,
                      f"{wl_name}: spgemm returns CRS iff estimate {est} < "
                      f"{P.spgemm.SPARSE_OUTPUT_THRESHOLD}")
                line.update(estimate=est, output=type(out).__name__)
                if sparse_out:
                    out = torch.from_numpy(out.to_dense()).to("cuda")
            check(tuple(out.shape) == (m, m) and
                  bool(torch.isfinite(out).all()),
                  f"{wl_name} {entry} {variant}: finite ({m}, {m})")
            err = float((out.double() - ref).abs().max())
            check(err <= SERVE_TOL * scale,
                  f"{wl_name} {entry} {variant} R={rounds}: max|err| {err} "
                  f"> {SERVE_TOL} * {scale}")
            line["max_rel_err"] = err / scale
            emit(line)
            del out
        del ref
    launches = _counters(P)
    for name, _, _ in SPGEMM_KERNELS:
        check(launches[name] > 0, f"{name} ran on the spgemm path")
    instances = _instances(P)
    for name in NEW_INSTANCES:
        check(instances[name] > 0, f"{name} ran on the spgemm path")
    emit({"phase": "spgemm_instances", "launches": instances})
    return launches


def phase_spgemm_alloc(torch, P, table4):
    """The sequence behind one slow call of an earlier run (mesh-bates,
    condense + merge at R = 32, 11 s of wall after mesh-mks4's 13.5 GB of
    stripes): mesh-mks4's condense + merge at R = 128, then mesh-bates' at
    R = 32, with the allocator's cache warm and after emptying it, each
    call's wall, CPU time and allocator counters; and one fresh cudaMalloc
    of bates' 3.6 GB stripe array alone."""
    lines = []
    for cache in ("warm", "emptied", "warm"):
        for wl_name, rounds in (("mesh-mks4", 128), ("mesh-bates", 32)):
            if cache == "emptied":
                torch.cuda.empty_cache()
            crs = table4[wl_name]
            mem0 = torch.cuda.memory_stats()
            cpu0, t0 = time.process_time(), time.perf_counter()
            out = P.ops.spmm(crs, crs, variant="condense_merge",
                             rounds=rounds, device="cuda")
            torch.cuda.synchronize()
            lines.append({
                "workload": wl_name, "rounds": rounds, "cache": cache,
                "wall_ms": (time.perf_counter() - t0) * 1e3,
                "cpu_ms": (time.process_time() - cpu0) * 1e3,
                "alloc": {k: torch.cuda.memory_stats().get(k, 0) -
                          mem0.get(k, 0) for k in ALLOC_STATS}})
            del out
    mp, n_rounds, _ = _prep_shape(P.ops, table4["mesh-bates"], 32)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    block = torch.empty((n_rounds, mp, mp), device="cuda")
    torch.cuda.synchronize()
    malloc_ms = (time.perf_counter() - t0) * 1e3
    del block
    torch.cuda.empty_cache()
    emit({"phase": "spgemm_alloc", "calls": lines,
          "fresh_stripes_malloc_ms": malloc_ms,
          "stripes_bytes": 4 * n_rounds * mp * mp})


def phase_spgemm_times(torch, P, crs, inc, errs, launches):
    rounds = 128
    ai, av = P.ops.prep_rounds(crs, rounds, device="cuda")
    bi, bv = P.ops.prep_rounds(crs, rounds, device="cuda")
    kw = dict(rounds=rounds, bm=128, bn=128)
    flush = torch.empty(64 * 2 ** 20, device="cuda")     # 256 MB
    mp, n_rounds, _ = ai.shape
    m = crs.shape[0]
    live = int((ai >= 0).sum()) + int((bi >= 0).sum())
    pairs = _matched_pairs(crs)
    idx_bytes = (ai.numel() + bi.numel()) * 4 + live * 4
    stripe_bytes = n_rounds * mp * mp * 4
    prep = P.ops.prepare_incrs(inc, pad_rows_to=8, device="cuda")
    n_live_g = int(((prep.idx >= 0) & (prep.idx < prep.section)).sum())
    gather_out = prep.padded_rows * prep.n_sections * prep.section * 4
    work = {  # name: (bytes, flops)
        "index_match_spmm": (idx_bytes + m * m * 4, 2 * pairs),
        "spgemm_condense": (idx_bytes + stripe_bytes, 2 * pairs),
        "spgemm_merge": (stripe_bytes + mp * mp * 4, n_rounds * mp * mp),
        "incrs_gather": (prep.idx.numel() * 4 + n_live_g * 4 + gather_out,
                         0),
    }
    stripes = P.SK.spgemm_condense(ai, av, bi, bv, **kw)
    runs = {
        "index_match_spmm": (lambda: P.IM.index_match_spmm(ai, av, bi, bv,
                                                           **kw),
                             lambda: P.IM.plain(ai, av, bi, bv, **kw)),
        "spgemm_condense": (lambda: P.SK.spgemm_condense(ai, av, bi, bv,
                                                         **kw),
                            lambda: P.SK.plain_condense(ai, av, bi, bv,
                                                        **kw)),
        "spgemm_merge": (lambda: P.SK.spgemm_merge(stripes, bm=128, bn=128),
                         lambda: P.SK.plain_merge(stripes, bm=128, bn=128)),
        "incrs_gather": (lambda: P.G.incrs_gather(prep.idx, prep.val,
                                                  section=prep.section,
                                                  bm=8),
                         lambda: P.G.plain(prep.idx, prep.val,
                                           section=prep.section, bm=8)),
    }
    a_csr = torch.sparse_csr_tensor(
        torch.from_numpy(crs.row_ptr), torch.from_numpy(
            crs.col_idx.astype(np.int64)),
        torch.from_numpy(crs.values), size=crs.shape,
        check_invariants=True).to("cuda")
    at_csr = a_csr.to_dense().T.contiguous().to_sparse_csr()
    a_dense = a_csr.to_dense()
    library = {
        "index_match_spmm": _time_ms(torch, lambda: torch.sparse.mm(
            a_csr, at_csr), flush, reps=10),
        "spgemm_condense": None,
        "spgemm_merge": _time_ms(torch, lambda: stripes.sum(0), flush),
        "incrs_gather": _time_ms(torch, lambda: a_csr.to_dense(), flush),
    }
    dense_mm_ms = _time_ms(torch, lambda: a_dense @ a_dense.T, flush)
    # the first designs, in the same run (general instances)
    first = {
        "spgemm_merge": P.SK.merge_geometry(mp * mp, n_rounds,
                                            instance="general"),
        "incrs_gather": P.G.gather_geometry(*prep.idx.shape, prep.section,
                                            instance="general"),
    }
    first_ms = {
        "spgemm_merge": _time_ms(torch, lambda: P.SK.spgemm_merge(
            stripes, geometry=first["spgemm_merge"]), flush),
        "incrs_gather": _time_ms(torch, lambda: P.G.incrs_gather(
            prep.idx, prep.val, section=prep.section,
            geometry=first["incrs_gather"]), flush),
    }
    rows, line = [], {}
    for name, source, replaces in SPGEMM_KERNELS:
        fn, plain = runs[name]
        ms = _time_ms(torch, fn, flush)
        plain_ms = _time_ms(torch, plain, flush, reps=5)
        nbytes, flops = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations", "library_ms": library[name]})
        line[name] = {"ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
                      "flops": flops, "bound_bytes_ms": t_bytes,
                      "bound_ops_ms": t_ops, "library_ms": library[name]}
        if name in first_ms:
            line[name]["first_design_ms"] = first_ms[name]
    emit({"phase": "spgemm_times", "workload": "mesh-docword4",
          "rounds": rounds, "prep": list(ai.shape),
          "gather_stripes": list(prep.idx.shape), "matched_pairs": pairs,
          "library": {"index_match_spmm": "torch.sparse.mm(A_csr, At_csr)",
                      "spgemm_merge": "stripes.sum(0)",
                      "incrs_gather": "A_csr.to_dense()"},
          "dense_mm_ms": dense_mm_ms, "kernels": line})
    return rows


def _match_work(ai, bi, pairs, m, stripes, n=None):
    """(bytes, flops) that index matching (``stripes`` False: C, m x n, n
    = m by default) or condense (the f32 stripes) must move and do: both
    idx arrays in full (pads are read to be skipped), the live values, the
    output once; 2 flops per matched pair."""
    live = int((ai >= 0).sum()) + int((bi >= 0).sum())
    nbytes = (ai.numel() + bi.numel()) * 4 + live * 4
    out = ai.shape[1] * ai.shape[0] * bi.shape[0] if stripes \
        else m * (m if n is None else n)
    return nbytes + out * 4, 2 * pairs


def _bound_ms(work):
    return max(work[0] / HBM_BYTES_PER_S, work[1] / F32_FLOP_PER_S) * 1e3


# Flushes queued ahead of each timed index-matching call in the operand
# and geometry phases: at mesh-arenas the kernels take 0.05 ms, less than
# the wrapper's host time, and one flush (0.08 ms) left the card idle.
MATCH_LEAD = 4


def _merge_work(stripes):
    """(bytes, flops) of merge: the stripes read once, C written once; a
    flop a stripe element."""
    n_rounds, m, n = stripes.shape
    return (n_rounds + 1) * m * n * 4, n_rounds * m * n


def _gather_work(prep):
    """(bytes, flops) of the gather: the idx stripes in full (pads are read
    to be skipped), the live values, the dense output once."""
    live = int(((prep.idx >= 0) & (prep.idx < prep.section)).sum())
    out = prep.idx.shape[0] * prep.idx.shape[1] * prep.section
    return prep.idx.numel() * 4 + live * 4 + out * 4, 0


def _stream_row(torch, run, geometry, library, work, flush, yardsticks):
    """One stream kernel on one operand: the instance its rule picks and
    each instance's median time (``run(geometry)``), the first design
    bitwise equal to the rule's launch, beside the library call, the
    bound, and ``yardsticks``: torch calls that move the same bytes with
    no arithmetic, what the card reaches on such traffic."""
    rule = run(None)
    row = {"picked": geometry(None).instance}
    for inst in ("general", row["picked"]):
        geo = geometry(inst)
        check(torch.equal(run(geo), rule),
              f"{inst} instance bitwise equal to the rule's launch")
        row[f"{inst}_ms"] = _time_ms(torch, lambda: run(geo), flush)
    row["library_ms"] = _time_ms(torch, library, flush)
    for name, fn in yardsticks.items():
        row[name] = _time_ms(torch, fn, flush)
    row["bytes"] = work[0]
    row["bound_ms"] = _bound_ms(work)
    return row


def phase_spgemm_operands(torch, P, table4):
    """Every Table IV operand at R = 128 (and at R = 32 where its stripes
    fit ``STRIPES_MAX_BYTES``): index matching and condense (R = 128, and
    mesh-docword4 at R = 32), each in the ring instance and in the general
    one (the first design, unchanged: the times before), beside
    torch.sparse.mm(A_csr, At_csr), the bound and the ring's packing
    pre-pass alone; merge on the condensed stripes (ring and general,
    beside stripes.sum(0)) and, at R = 128, the gather of the operand's
    section stripes (tile and general, beside A_csr.to_dense()); median
    of 30 launches with L2 flushed; the instance each rule picks."""
    flush = torch.empty(64 * 2 ** 20, device="cuda")     # 256 MB
    lines = []
    cases = [(name, 128) for name in table4]
    for name, crs in table4.items():
        mp, n_rounds, _ = _prep_shape(P.ops, crs, 32)
        if 4 * n_rounds * mp * mp < STRIPES_MAX_BYTES:
            cases.append((name, 32))
    for wl_name, rounds in cases:
        crs = table4[wl_name]
        ai, av = P.ops.prep_rounds(crs, rounds, device="cuda")
        bi, bv = P.ops.prep_rounds(crs, rounds, device="cuda")
        m = crs.shape[0]
        pairs = _matched_pairs(crs)
        line = {"phase": "spgemm_operand", "workload": wl_name,
                "rounds": rounds, "prep": list(ai.shape)}
        a_csr = torch.sparse_csr_tensor(
            torch.from_numpy(crs.row_ptr),
            torch.from_numpy(crs.col_idx.astype(np.int64)),
            torch.from_numpy(crs.values), size=crs.shape).to("cuda")
        if rounds == 128 or wl_name == "mesh-docword4":
            for kernel, fn in (("index_match_spmm", P.IM.index_match_spmm),
                               ("spgemm_condense", P.SK.spgemm_condense)):
                row = {"picked": _match_geo(P, ai, bi, rounds,
                                            kernel).instance}
                for inst in P.IM.INSTANCES:
                    geo = _match_geo(P, ai, bi, rounds, kernel,
                                     instance=inst)
                    row[f"{inst}_ms"] = _time_ms(torch, lambda: fn(
                        ai, av, bi, bv, rounds=rounds, geometry=geo), flush,
                        lead=MATCH_LEAD)
                row["bound_ms"] = _bound_ms(_match_work(
                    ai, bi, pairs, m, kernel == "spgemm_condense"))
                line[kernel] = row
            at_csr = a_csr.to_dense().T.contiguous().to_sparse_csr()
            line["sparse_mm_ms"] = _time_ms(
                torch, lambda: torch.sparse.mm(a_csr, at_csr), flush,
                reps=10, lead=MATCH_LEAD)
            del at_csr
            line["pack_ms"] = _time_ms(
                torch, lambda: P.IM.pack(ai, av, bi, bv, rounds), flush,
                lead=MATCH_LEAD)
        stripes = P.SK.spgemm_condense(ai, av, bi, bv, rounds=rounds)
        del ai, av, bi, bv
        n_rounds, sm, sn = stripes.shape
        line["spgemm_merge"] = _stream_row(
            torch, lambda geo: P.SK.spgemm_merge(stripes, geometry=geo),
            lambda inst: P.SK.merge_geometry(sm * sn, n_rounds,
                                             instance=inst),
            lambda: stripes.sum(0), _merge_work(stripes), flush,
            {"read_ms": lambda: stripes.sum()})     # the stripes, read
        line["spgemm_merge"]["geometry"] = \
            P.SK.merge_geometry(sm * sn, n_rounds)._asdict()
        del stripes
        torch.cuda.empty_cache()
        if rounds == 128:
            prep = P.ops.prepare_incrs(P.InCRS.from_crs(crs), pad_rows_to=8,
                                       device="cuda")
            shape = (*prep.idx.shape, prep.section)
            dense = torch.empty((shape[0], shape[1] * shape[3]),
                                device="cuda")
            line["incrs_gather"] = _stream_row(
                torch, lambda geo: P.G.incrs_gather(
                    prep.idx, prep.val, section=prep.section, geometry=geo),
                lambda inst: P.G.gather_geometry(*shape, instance=inst),
                lambda: a_csr.to_dense(), _gather_work(prep), flush,
                {"write_ms": dense.zero_,      # the dense output, written
                 # the stripes read and the dense output written: each
                 # (row, section) padded from smax to section columns
                 "pad_ms": lambda: torch.nn.functional.pad(
                     prep.val, (0, max(0, shape[3] - shape[2])))})
            line["incrs_gather"]["stripes"] = list(shape)
            line["incrs_gather"]["geometry"] = \
                P.G.gather_geometry(*shape)._asdict()
            del prep, dense
        emit(line)
        lines.append(line)
        del a_csr
        torch.cuda.empty_cache()
    return lines


# Ring geometries off the rule at mesh-docword4, R = 128 (the rule's own
# first): index matching at other rows per warp (tile heights of 14 x
# rpw) and ring depths; condense at other rows per warp, ring depths and
# (tile, round) items a CTA: 94, one tile's rounds a CTA (84 CTAs); 24; 1,
# one item a CTA (7,896 CTAs). The rule gives 132 CTAs 60 items each.
MATCH_SWEEP = {
    "index_match_spmm": [{}, {"rows_per_warp": 5}, {"rows_per_warp": 8},
                         {"rows_per_warp": 12}, {"rows_per_warp": 16},
                         {"stages": 4}, {"stages": 8}],
    "spgemm_condense": [{}, {"rows_per_warp": 8}, {"rows_per_warp": 12},
                        {"stages": 4}, {"stages": 8}, {"chunk": 94},
                        {"chunk": 24}, {"chunk": 1}],
}


def phase_spgemm_geometries(torch, P, crs, large, small):
    """The ring at other geometries, each held bit for bit to the rule's
    (condense through merge), and each instance's CTAs an SM from the
    card's occupancy calculator: the ring's persistent grid must fit one
    wave of them. Then the same for the gather and merge (merge also on
    ``large``'s stripes, the gather also on ``small``'s)."""
    flush = torch.empty(64 * 2 ** 20, device="cuda")
    rounds = 128
    ai, av = P.ops.prep_rounds(crs, rounds, device="cuda")
    bi, bv = P.ops.prep_rounds(crs, rounds, device="cuda")
    want = P.IM.index_match_spmm(ai, av, bi, bv, rounds=rounds)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    occupancy, sweep = {}, []
    for kernel, overrides in MATCH_SWEEP.items():
        for inst in P.IM.INSTANCES:
            geo = _match_geo(P, ai, bi, rounds, kernel, instance=inst)
            ctas = P.IM.ctas_per_sm(geo)
            check(ctas == P.IM.CTAS_PER_SM[inst],
                  f"{kernel} {inst}: {ctas} CTAs an SM, the geometry "
                  f"assumes {P.IM.CTAS_PER_SM[inst]}")
            if inst == "ring":
                check(geo.grid <= sms * ctas, f"{kernel} ring grid "
                      f"{geo.grid} fits one wave of {sms} x {ctas}")
            occupancy[f"{kernel}/{inst}"] = {
                "ctas_per_sm": ctas, "grid": geo.grid, "smem": geo.smem,
                "threads": geo.threads}
        for over in overrides:
            geo = _match_geo(P, ai, bi, rounds, kernel, instance="ring",
                             **over)
            if kernel == "index_match_spmm":
                run = lambda: P.IM.index_match_spmm(
                    ai, av, bi, bv, rounds=rounds, geometry=geo)
                same = torch.equal(run(), want)
            else:
                run = lambda: P.SK.spgemm_condense(
                    ai, av, bi, bv, rounds=rounds, geometry=geo)
                same = torch.equal(P.SK.spgemm_merge(run()), want)
            check(same, f"{kernel} at {over} bitwise equal to the rule's")
            sweep.append({"kernel": kernel, "override": over,
                          "rows_per_warp": geo.rows_per_warp,
                          "tile_m": geo.tile_m, "stages": geo.stages,
                          "cap": geo.cap, "grid": geo.grid,
                          "chunk": geo.chunk,
                          "ms": _time_ms(torch, run, flush,
                                         lead=MATCH_LEAD)})
            torch.cuda.empty_cache()
    del want
    stream_sweep = _stream_sweep(torch, P, crs, ai, av, bi, bv, rounds,
                                 flush, sms, occupancy)
    prep = list(ai.shape)
    del ai, av, bi, bv
    stream_sweep += _merge_sweep_large(torch, P, large, rounds, flush)
    stream_sweep += _gather_sweep(torch, P, small, "mesh-sch",
                                  GATHER_SWEEP_SMALL, flush)
    emit({"phase": "spgemm_geometries", "workload": "mesh-docword4",
          "rounds": rounds, "prep": prep, "sms": sms,
          "occupancy": occupancy, "sweep": sweep,
          "stream_sweep": stream_sweep})


# The stream kernels off their rules at mesh-docword4: the gather's tile
# at 1 to 8 sections an item (the rule takes 2: 154 slots, one batch); the
# merge ring at chunks of 1,024 to 8,192 floats (the rule takes 3,072,
# at most three a CTA on 264 CTAs; 5,960 splits the plane evenly over 132
# SMs off 128-byte lines) and 2 to 8 stages (the rule takes 4).
GATHER_SWEEP = [{}, {"sections": 1}, {"sections": 3}, {"sections": 4},
                {"sections": 6}, {"sections": 8}]
MERGE_SWEEP = [{}, {"stages": 2}, {"stages": 3}, {"stages": 6},
               {"stages": 8}, {"chunk": 1024}, {"chunk": 2048},
               {"chunk": 4096}, {"chunk": 5960}, {"chunk": 6144},
               {"chunk": 8192}, {"chunk": 8192, "stages": 3}]


# Merge's ring at mesh-mks4, R = 128 (13.5 GB of stripes; the rule takes
# 4,096 floats, at most 53 a CTA on 264 CTAs).
MERGE_SWEEP_LARGE = [{}, {"chunk": 2048}, {"chunk": 3072}, {"chunk": 6144},
                     {"chunk": 8192, "stages": 3}]
# The gather's tile at mesh-sch, whose stripes hold 3 slots a section
# (3600, 15, 3): items of 1 to 15 sections (the whole row).
GATHER_SWEEP_SMALL = [{}, {"sections": 1}, {"sections": 2}, {"sections": 4},
                      {"sections": 8}, {"sections": 15},
                      {"instance": "general"}]


def _gather_sweep(torch, P, crs, name, overrides, flush):
    """The gather at ``overrides`` of its rule on ``crs``'s section
    stripes, each bitwise equal to the rule's launch."""
    prep = P.ops.prepare_incrs(P.InCRS.from_crs(crs), pad_rows_to=8,
                               device="cuda")
    shape = (*prep.idx.shape, prep.section)
    want = P.G.incrs_gather(prep.idx, prep.val, section=prep.section)
    sweep = []
    for over in overrides:
        geo = P.G.gather_geometry(*shape, **over)
        run = lambda: P.G.incrs_gather(prep.idx, prep.val,
                                       section=prep.section, geometry=geo)
        check(torch.equal(run(), want),
              f"incrs_gather at {over} bitwise equal to the rule's")
        sweep.append({"kernel": "incrs_gather", "workload": name,
                      "override": over, "geometry": geo._asdict(),
                      "ms": _time_ms(torch, run, flush)})
    return sweep


def _merge_sweep_large(torch, P, crs, rounds, flush):
    ai, av = P.ops.prep_rounds(crs, rounds, device="cuda")
    stripes = P.SK.spgemm_condense(ai, av, ai, av, rounds=rounds)
    del ai, av
    n_rounds, sm, sn = stripes.shape
    want = P.SK.spgemm_merge(stripes)
    sweep = []
    for over in MERGE_SWEEP_LARGE:
        geo = P.SK.merge_geometry(sm * sn, n_rounds, **over)
        run = lambda: P.SK.spgemm_merge(stripes, geometry=geo)
        check(torch.equal(run(), want),
              f"spgemm_merge at {over} bitwise equal to the rule's")
        sweep.append({"kernel": "spgemm_merge", "workload": "mesh-mks4",
                      "override": over, "geometry": geo._asdict(),
                      "ms": _time_ms(torch, run, flush)})
    del stripes, want
    torch.cuda.empty_cache()
    return sweep


def _stream_sweep(torch, P, crs, ai, av, bi, bv, rounds, flush, sms,
                  occupancy):
    """Each stream kernel's CTAs an SM from the occupancy calculator (the
    tile's must be what its geometry assumes, and each persistent grid one
    wave), then the sweeps, each launch bitwise equal to the rule's."""
    stripes = P.SK.spgemm_condense(ai, av, bi, bv, rounds=rounds)
    n_rounds, sm, sn = stripes.shape
    prep = P.ops.prepare_incrs(P.InCRS.from_crs(crs), pad_rows_to=8,
                               device="cuda")
    shape = (*prep.idx.shape, prep.section)
    kernels = {
        "incrs_gather": (
            lambda **kw: P.G.gather_geometry(*shape, **kw),
            lambda geo: P.G.incrs_gather(prep.idx, prep.val,
                                         section=prep.section, geometry=geo),
            P.G.ctas_per_sm, GATHER_SWEEP),
        "spgemm_merge": (
            lambda **kw: P.SK.merge_geometry(sm * sn, n_rounds, **kw),
            lambda geo: P.SK.spgemm_merge(stripes, geometry=geo),
            P.SK.merge_ctas_per_sm, MERGE_SWEEP),
    }
    sweep = []
    for kernel, (geometry, run, ctas_of, overrides) in kernels.items():
        rule = geometry()
        want = run(None)
        for inst in ("general", rule.instance):
            geo = geometry(instance=inst)
            ctas = ctas_of(geo)
            if inst != "general":
                check(ctas >= 1 and geo.grid <= sms * ctas,
                      f"{kernel} {inst} grid {geo.grid} fits one wave of "
                      f"{sms} x {ctas}")
            if kernel == "incrs_gather" and inst == "tile":
                check(ctas == geo.ctas_per_sm, f"incrs_gather tile: {ctas} "
                      f"CTAs an SM, the geometry assumes {geo.ctas_per_sm}")
            occupancy[f"{kernel}/{inst}"] = {
                "ctas_per_sm": ctas, "grid": geo.grid, "smem": geo.smem,
                "threads": geo.threads}
        for over in overrides:
            geo = geometry(**over)
            check(torch.equal(run(geo), want),
                  f"{kernel} at {over} bitwise equal to the rule's")
            sweep.append({"kernel": kernel, "override": over,
                          "geometry": geo._asdict(),
                          "ctas_per_sm": ctas_of(geo),
                          "ms": _time_ms(torch, lambda: run(geo), flush)})
    del stripes, prep
    torch.cuda.empty_cache()
    return sweep


# ----------------------------------------------------------------------
# The plan–execute path: bsr and dense operands behind plan_for_operand,
# on the BSR and the dense kernels (f32 FMA and bf16 wgmma instances of
# one GEMM core, and the general kernels for other shapes).
def _granite(Q):
    """The granite-34b MLP operand: the bsr Linear of W_up and its pruned
    dense A = W_up^T (host f32)."""
    g = GRANITE
    w = np.random.default_rng(g["seed"]).standard_normal(
        (g["d_model"], g["d_ff"]), dtype=np.float32)
    w *= g["scale"]
    lin = Q.api.Linear.from_dense(w, Q.api.SparseSpec(
        "bsr", density=g["density"], block=g["block"]), device="cuda")
    del w
    return lin, np.ascontiguousarray(lin.to_dense().T)


def _held(torch, Q, mod, kname, run, plain, want64, geo, label):
    """One kernel call on the card, twice: the two launches bitwise equal
    and counted on the instance ``geo`` names; against the plain version
    on the same inputs (f32: ``KERNEL_TOL * max|C|``; bf16: per row,
    ``BF16_TOL * `` that row's max|C|, as ``worst_row_error``) and, in
    f32, against the float64 product ``want64`` (``SERVE_TOL``)."""
    before = dict(mod.INSTANCE_LAUNCHES)
    n0 = mod.LAUNCHES[kname]
    out = run()
    again = run()
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in mod.INSTANCE_LAUNCHES.items()
             if v != before[k]}
    check(mod.LAUNCHES[kname] == n0 + 2 and moved == {geo.instance: 2},
          f"{kname} on {label}: two launches of {geo.instance}, got "
          f"{moved}")
    check(torch.equal(out, again), f"{kname} {geo.instance} (S = "
          f"{geo.splits}) on {label}: two launches bitwise equal")
    ref = plain()
    check(bool(torch.isfinite(out).all()) and out.shape == ref.shape and
          out.dtype == ref.dtype, f"{kname} finite, right shape and type "
          f"on {label}")
    err = float((out.float() - ref.float()).abs().max())
    line = {"instance": geo.instance, "splits": geo.splits,
            "dtype": str(out.dtype).replace("torch.", ""),
            "max_abs_err": err}
    scale = max(float(want64.abs().max()), 1e-30)
    err64 = float((out.double() - want64).abs().max())
    line["max_rel_err_f64"] = err64 / scale
    if out.dtype == torch.bfloat16:
        row = Q.F.worst_row_error(out, ref)
        line["worst_row_err"] = row
        check(row <= BF16_TOL, f"{kname} bf16 on {label}: worst row "
              f"{row} > {BF16_TOL}")
    else:
        check(err <= KERNEL_TOL * scale, f"{kname} on {label}: max|err| "
              f"{err} > {KERNEL_TOL} * {scale}")
        check(err64 <= SERVE_TOL * scale, f"{kname} on {label} vs float64: "
              f"{err64} > {SERVE_TOL} * {scale}")
    return line


def _bsr_check(torch, Q, row_of, col_of, slots, row_start, b, nbr, a64,
               label):
    """The BSR kernel against its plain version and the float64 product
    ``a64 @ b`` (``a64`` the operand in float64 on the card)."""
    geo = Q.KB.gemm_geometry(nbr, slots.shape[1], slots.shape[2],
                             b.shape[1], torch.promote_types(slots.dtype,
                                                             b.dtype),
                             nnz=slots.shape[0])
    return _held(
        torch, Q, Q.KB, "bsr_spmm",
        lambda: Q.KB.bsr_spmm(row_of, col_of, slots, b, n_block_rows=nbr,
                              row_start=row_start),
        lambda: Q.KB.plain(row_of, col_of, slots, b, n_block_rows=nbr),
        a64 @ b.double(), geo, label)


def _dense_check(torch, Q, a, b, label):
    geo = Q.KD.gemm_geometry(a.shape[0], b.shape[1], a.shape[1],
                             torch.promote_types(a.dtype, b.dtype))
    return _held(torch, Q, Q.KD, "dense_mm", lambda: Q.ops.dense_mm(a, b),
                 lambda: Q.KD.plain(a, b), a.double() @ b.double(), geo,
                 label)


def _bsr_edges():
    """(label, A, (bm, bk), N): operands that reach each masked edge."""
    rng = np.random.default_rng(23)

    def blocky(m, k, bm, bk, d, empty=()):
        keep = rng.random((m // bm, k // bk)) < d
        keep[list(empty)] = False
        a = rng.uniform(-1.5, 1.5, size=(m, k)).astype(np.float32)
        return (a.reshape(m // bm, bm, k // bk, bk) *
                keep[:, None, :, None]).reshape(m, k)

    return [("empty_block_rows", blocky(640, 768, 64, 64, 0.4, (0, 3, 9)),
             (64, 64), 512),
            ("all_empty", np.zeros((256, 384), np.float32), (32, 32), 256),
            ("n_1", blocky(500, 600, 50, 50, 0.5), (50, 50), 1),
            ("n_129", blocky(500, 600, 50, 50, 0.5, (2,)), (50, 50), 129),
            ("rect_32x64", blocky(512, 1024, 32, 64, 0.3, (1,)), (32, 64),
             320),
            # split-K over short runs: 8 block-rows x 1 column tile
            ("split_k", blocky(1024, 4096, 128, 128, 0.3), (128, 128), 128),
            # block-rows of 1 to 32 blocks
            ("skewed", _skewed_blocks(rng), (128, 128), 256)]


def _skewed_blocks(rng):
    """A (1024, 4096) operand of 128 x 128 blocks whose eight block-rows
    hold 1, 2, 4, ..., 32 and 0 blocks."""
    a = np.zeros((1024, 4096), np.float32)
    for r, count in enumerate((1, 2, 4, 8, 16, 32, 0, 3)):
        for c in rng.choice(32, size=count, replace=False):
            a[r * 128:(r + 1) * 128, c * 128:(c + 1) * 128] = \
                rng.uniform(-1.5, 1.5, size=(128, 128))
    return a


def phase_plan_kernels(torch, Q, table2, granite):
    gen = torch.Generator(device="cuda").manual_seed(3)
    results, errs = [], {}
    bf16 = torch.bfloat16
    for wl_name, block in TABLE2_BLOCK.items():
        a = table2[wl_name].crs.to_dense()
        bsr = Q.BSR.from_dense(a, (block, block))
        row_of, col_of, slots, rs = Q.ops.prep_bsr(bsr, device="cuda")
        b = torch.randn(a.shape[1], 512, generator=gen, device="cuda")
        a64 = torch.from_numpy(a).to("cuda").double()
        line = {"operand": wl_name, "kernel": "bsr_spmm", "shape":
                list(a.shape), "block": block, "live_blocks": bsr.nnz_blocks,
                "blocks": bsr.n_block_rows * bsr.n_block_cols, "n": 512,
                **_bsr_check(torch, Q, row_of, col_of, slots, rs, b,
                             bsr.n_block_rows, a64,
                             f"{wl_name} block {block}")}
        if wl_name == "incrs-docword":
            a_t = a64.float()
            for a_in, b_in in ((a_t, b), (a_t.to(bf16), b.to(bf16))):
                results.append({"operand": wl_name, "kernel": "dense_mm",
                                "shape": list(a.shape), "n": 512,
                                **_dense_check(torch, Q, a_in, b_in,
                                               "docword dense")})
            del a_t
        results.append(line)
        del a64, slots, b
    lin, a_g = granite
    meta = lin.meta
    row_of, col_of, row_start = meta.kernel_index(torch.device("cuda"))
    slots = Q.lin_mod._pad_slots(lin.values.detach(), meta)
    b = torch.randn(a_g.shape[1], 512, generator=gen, device="cuda")
    a_t = torch.from_numpy(a_g).to("cuda")
    a64 = a_t.double()
    blocks = meta.n_block_rows * meta.n_block_rows_t
    check(meta.nnz == round(GRANITE["density"] * blocks),
          f"granite operand keeps {GRANITE['density']} of {blocks} blocks, "
          f"got {meta.nnz}")
    # f32, then bf16 by casting the same device tensors
    for dt in (torch.float32, bf16):
        s_in, a_in, b_in = slots.to(dt), a_t.to(dt), b.to(dt)
        eb = _bsr_check(torch, Q, row_of, col_of, s_in, row_start, b_in,
                        meta.n_block_rows, a64, f"granite bsr {dt}")
        ed = _dense_check(torch, Q, a_in, b_in, f"granite dense {dt}")
        key = "" if dt == torch.float32 else "/bf16"
        errs["bsr_spmm" + key], errs["dense_mm" + key] = eb, ed
        for kname, e in (("bsr_spmm", eb), ("dense_mm", ed)):
            results.append({"operand": GRANITE_NAME, "kernel": kname,
                            "shape": list(a_g.shape), "block": 128,
                            "live_blocks": meta.nnz, "blocks": blocks,
                            "n": 512, **e})
        del s_in, a_in, b_in
    del a_t, a64, slots, b
    for label, a, blk, n in _bsr_edges():
        bsr = Q.BSR.from_dense(a, blk)
        row_of, col_of, slots, rs = Q.ops.prep_bsr(bsr, device="cuda")
        b = torch.randn(a.shape[1], n, generator=gen, device="cuda")
        a64 = torch.from_numpy(a).to("cuda").double()
        dts = (torch.float32, bf16) if label in ("n_129", "split_k",
                                                 "skewed") \
            else (torch.float32,)
        for dt in dts:
            results.append({"operand": label, "kernel": "bsr_spmm",
                            "shape": list(a.shape), "block": list(blk),
                            "live_blocks": bsr.nnz_blocks, "n": n,
                            **_bsr_check(torch, Q, row_of, col_of,
                                         slots.to(dt), rs, b.to(dt),
                                         bsr.n_block_rows, a64, label)})
    for m, k, n in ((1, 1, 1), (127, 129, 300), (300, 7, 129)):
        a = torch.randn(m, k, generator=gen, device="cuda")
        b = torch.randn(k, n, generator=gen, device="cuda")
        dts = (torch.float32, bf16) if (m, k, n) == (127, 129, 300) \
            else (torch.float32,)
        for dt in dts:
            results.append({"operand": f"ragged {m}x{k}x{n}",
                            "kernel": "dense_mm", "shape": [m, k], "n": n,
                            **_dense_check(torch, Q, a.to(dt), b.to(dt),
                                           f"{m}x{k}x{n} {dt}")})
    emit({"phase": "plan_kernels",
          "tolerance": f"f32: max|kernel-plain| <= {KERNEL_TOL} * max|C|, "
                       f"max|kernel-float64| <= {SERVE_TOL} * max|C|; bf16: "
                       f"per row, max|kernel-plain| <= {BF16_TOL} * the "
                       f"row's max|C|; every call twice, bitwise equal",
          "checks": results})
    torch.cuda.empty_cache()
    return errs


_LAUNCHER_NUMBERS = {   # the rates of two waves: printed, not a cell
    "waves_first": r"waves=(\d+)",
    "requests_per_s": r"([\d.]+) req/s",
    "latency_ms_p50": r"p50=([\d.]+)ms",
    "latency_ms_p99": r"p99=([\d.]+)ms",
    "max_rel_err": r"float64 oracle: ([\d.e+-]+)",
    "plan_host_ms": r"on the host: ([\d.]+) ms",
    "max_rel_err_swapped": r"max \|err\| / max\|C\|: ([\d.e+-]+)",
    "waves": r"waves total (\d+)",
}


def _run_launcher(args):
    """The launcher as a subprocess: a check of its exit code, its error
    against float64 and its launches. Its rate and latency are printed
    as it reports them, but two waves of requests measure no rate: the
    engine runs of phase plan_serve do."""
    import re
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--spmm",
           "--device", "cuda", "--n-requests", "16", *args]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    line = {"phase": "plan_serve", "entry": "launcher",
            "cmd": " ".join(cmd[3:]), "rc": proc.returncode}
    if proc.returncode != 0:
        emit({**line, "stdout": proc.stdout[-2000:],
              "stderr": proc.stderr[-2000:]})
    check(proc.returncode == 0, f"launcher {' '.join(args)} exited 0")
    for key, pat in _LAUNCHER_NUMBERS.items():
        m = re.search(pat, proc.stdout)
        if m:
            line[key] = float(m.group(1))
    m = re.search(r"kernel launches (\{.*\})", proc.stdout)
    check(m is not None, "launcher printed its kernel launches")
    line["launches"] = json.loads(m.group(1))
    return line


def _engine_run(torch, Q, bound, panels, ref, label):
    """One SpMMEngine run over ``bound``; every request against the float64
    product ``ref`` on the card."""
    eng = Q.engine.SpMMEngine(bound, max_wave_cols=512)
    reqs = [Q.engine.SpMMRequest(i, p) for i, p in enumerate(panels)]
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    check(len(done) == len(reqs) and all(r.done for r in reqs),
          f"{label}: every request served")
    off, worst = 0, 0.0
    for r in reqs:
        want = ref[:, off:off + r.b.shape[1]]
        off += r.b.shape[1]
        got = torch.from_numpy(r.out).to("cuda")
        check(tuple(got.shape) == tuple(want.shape) and
              bool(torch.isfinite(got).all()),
              f"{label} request {r.rid} finite, right shape")
        cmax = max(float(want.abs().max()), 1e-30)
        err = float((got.double() - want).abs().max())
        check(err <= SERVE_TOL * cmax, f"{label} request {r.rid}: {err} > "
              f"{SERVE_TOL} * {cmax}")
        worst = max(worst, err / cmax)
    return eng, worst


def _plan_counters(Q):
    return {**Q.K.LAUNCHES, **Q.KB.LAUNCHES, **Q.KD.LAUNCHES}


def _plan_operands(table2, granite):
    """(label, dense A, bsr block) of the plan path, one at a time."""
    for name, block in TABLE2_BLOCK.items():
        yield name, table2[name].crs.to_dense(), block
    yield GRANITE_NAME, granite[1], GRANITE["block"]


def phase_plan_serve(torch, Q, table2, granite):
    """The path, driven with the counters at 0 just before it:
    ``SpMMEngine(plan_for_operand(A, spec))`` as bsr and as dense on the
    five Table II operands and the granite operand, each with the
    mixed-width trace of phase serve. Then the launcher as a subprocess
    (--format bsr|dense on the Table II workloads, once --spmm-swap),
    checked for its exit code, its error and its launches."""
    Q.KB.reset_launches()
    Q.KD.reset_launches()
    kept = {}
    for label, a, block in _plan_operands(table2, granite):
        panels = _trace(a.shape[1], seed=1)
        a64 = torch.from_numpy(a).to("cuda").double()
        ref = a64 @ torch.from_numpy(np.concatenate(panels, axis=1)).to(
            "cuda").double()
        del a64
        for fmt in ("bsr", "dense"):
            spec = Q.api.SparseSpec(fmt, block=block if fmt == "bsr"
                                    else None)
            t0 = time.perf_counter()
            bound = Q.api.plan_for_operand(a, spec, device="cuda")
            torch.cuda.synchronize()
            plan_ms = (time.perf_counter() - t0) * 1e3
            before = _plan_counters(Q)
            eng, worst = _engine_run(torch, Q, bound, panels, ref,
                                     f"{label} {fmt}")
            moved = {k: v - before[k] for k, v in _plan_counters(Q).items()
                     if v != before[k]}
            kname = "bsr_spmm" if fmt == "bsr" else "dense_mm"
            check(moved == {kname: eng.stats["waves"]},
                  f"{label} {fmt}: launches {moved} are one {kname} per "
                  f"wave")
            s = eng.stats_summary()
            emit({"phase": "plan_serve",
                  "entry": "SpMMEngine(plan_for_operand)",
                  "operand": label, "format": fmt,
                  "block": block if fmt == "bsr" else None,
                  "a_shape": list(a.shape), "plan_host_ms": plan_ms,
                  "requests": s["requests"], "waves": s["waves"],
                  "split_requests": int(eng.stats["split_requests"]),
                  "launches": moved, "requests_per_s": s["requests_per_s"],
                  "latency_ms_p50": s["latency_ms"]["p50"],
                  "latency_ms_p99": s["latency_ms"]["p99"],
                  "wave_ms_p50": s["wave_ms"]["p50"],
                  "prep_overlap_fraction": s["prep_overlap_fraction"],
                  "max_rel_err": worst})
            if (label, fmt) in PROFILED:
                kept[(label, fmt)] = bound
            del bound, eng
        del ref
        torch.cuda.empty_cache()
    for fmt in ("bsr", "dense"):
        emit(_serve_bf16(torch, Q, table2, fmt))
    launches = {**Q.KB.LAUNCHES, **Q.KD.LAUNCHES}
    check(all(v > 0 for v in launches.values()),
          f"both plan kernels ran on the plan path: {launches}")
    by_launcher = {"bsr_spmm": 0, "dense_mm": 0}
    runs = [["--workload", name, "--format", fmt] +
            (["--spmm-block", str(block)] if fmt == "bsr" else [])
            for name, block in TABLE2_BLOCK.items()
            for fmt in ("bsr", "dense")]
    runs.append(["--workload", "incrs-docword", "--format", "bsr",
                  "--spmm-block", "50", "--spmm-swap"])
    for args in runs:
        line = _run_launcher(args)
        kname = "bsr_spmm" if "bsr" in args else "dense_mm"
        moved = {k: v for k, v in line["launches"].items() if v}
        check(moved == {kname: int(line["waves"])},
              f"launcher {' '.join(args)}: launches {moved} are one "
              f"{kname} per wave ({line['waves']})")
        by_launcher[kname] += moved[kname]
        emit(line)
    return launches, by_launcher, kept




def _serve_bf16(torch, Q, table2, fmt):
    """A bf16 plan of the docword operand (``Linear.from_dense(...,
    dtype=bfloat16)``, as bsr with block 50 or as dense) served by
    ``SpMMEngine`` with bf16 requests (CPU tensors) on the mixed-width
    trace: every wave launches the bf16 instance its shape takes, once,
    and each request is held per row against the float64 product of the
    bf16 values (``BF16_TOL`` of the row's max|C|)."""
    a = table2["incrs-docword"].crs.to_dense()
    block = TABLE2_BLOCK["incrs-docword"] if fmt == "bsr" else None
    spec = Q.api.SparseSpec(fmt, block=block, mask=np.ascontiguousarray(
        a != 0).T if fmt == "bsr" else None)
    lin = Q.api.Linear.from_dense(np.ascontiguousarray(a.T), spec,
                                  dtype=torch.bfloat16, device="cuda")
    bound = lin.bound()
    check(bound.values.dtype == torch.bfloat16, f"docword {fmt}: bf16 plan")
    a16 = torch.from_numpy(np.ascontiguousarray(lin.to_dense().T)).to(
        "cuda").double()
    panels = [torch.from_numpy(p).to(torch.bfloat16)
              for p in _trace(a.shape[1], seed=2)]
    ref = a16 @ torch.cat(panels, dim=1).to("cuda").double()
    mod, kname = (Q.KB, "bsr_spmm") if fmt == "bsr" else (Q.KD, "dense_mm")
    if fmt == "bsr":
        want = Q.KB.gemm_geometry(a.shape[0] // block, block, block, 128,
                                  torch.bfloat16, nnz=1).instance
    else:
        want = Q.KD.gemm_geometry(a.shape[0], 128, a.shape[1],
                                  torch.bfloat16).instance
    before, n0 = dict(mod.INSTANCE_LAUNCHES), mod.LAUNCHES[kname]
    eng = Q.engine.SpMMEngine(bound, max_wave_cols=512)
    reqs = [Q.engine.SpMMRequest(i, p) for i, p in enumerate(panels)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    moved = {k: v - before[k] for k, v in mod.INSTANCE_LAUNCHES.items()
             if v != before[k]}
    waves = int(eng.stats["waves"])
    check(moved == {want: waves} and mod.LAUNCHES[kname] - n0 == waves,
          f"docword bf16 {fmt}: launches {moved} are one {want} per wave "
          f"({waves})")
    off, worst = 0, 0.0
    for r in reqs:
        width = r.b.shape[1]
        check(r.done and isinstance(r.out, torch.Tensor) and
              r.out.dtype == torch.bfloat16 and
              tuple(r.out.shape) == (a.shape[0], width),
              f"docword bf16 {fmt} request {r.rid}: a bf16 panel")
        worst = max(worst, Q.F.worst_row_error(
            r.out.to("cuda"), ref[:, off:off + width]))
        off += width
    check(worst <= BF16_TOL, f"docword bf16 {fmt}: worst row {worst} > "
          f"{BF16_TOL}")
    s = eng.stats_summary()
    return {"phase": "plan_serve",
            "entry": "SpMMEngine(Linear.from_dense(dtype=bfloat16).bound())",
            "operand": "incrs-docword", "format": fmt, "block": block,
            "dtype": "bfloat16", "instance": want, "requests": s["requests"],
            "waves": waves, "launches": moved,
            "requests_per_s": s["requests_per_s"],
            "latency_ms_p50": s["latency_ms"]["p50"],
            "latency_ms_p99": s["latency_ms"]["p99"],
            "worst_row_err": worst}


def _plan_work(kname, a_shape, n, elem, nnz=None, block=None,
               live_cols=None):
    """(bytes, flops) the function needs with ``elem``-byte operands and
    C: each input read once (for BSR the stored values, the B block-rows
    some block references, the block lists), C written once; 2 flops per
    useful multiply-add."""
    m, k = a_shape
    if kname == "dense_mm":
        return (m * k + k * n + m * n) * elem, 2 * m * n * k
    bm, bk = block
    nbytes = (nnz * bm * bk + live_cols * bk * n + m * n) * elem + \
        (2 * nnz + m // bm + 2) * 4
    return nbytes, 2 * nnz * bm * bk * n


# The dense geometries timed beside the picked one, as overrides of
# gemm_geometry. f32: other K splits (fewer CTAs than slots, or a second
# wave) and deeper B rings; bf16: the other tile width and ring depths.
GEMM_SWEEP = {
    ("granite", "float32"): [{"stages": 3}, {"stages": 4}, {"splits": 2}],
    ("docword", "float32"): [{"splits": 1}, {"splits": 5}, {"splits": 22},
                             {"stages": 3}],
    ("granite", "bfloat16"): [{"tile_n": 128}, {"stages": 3},
                              {"stages": 2}],
    ("docword", "bfloat16"): [{"tile_n": 256}, {"splits": 1},
                              {"splits": 11}]}


def _plan_operands_timed(torch, Q, table2, granite, gen, n):
    """where -> (A on the card (f32), the block lists, block, nnz, live
    block columns, B (f32))."""
    lin, a_g = granite
    meta = lin.meta
    row_of, col_of, row_start = meta.kernel_index(torch.device("cuda"))
    slots = Q.lin_mod._pad_slots(lin.values.detach(), meta)
    out = {"granite": (torch.from_numpy(a_g).to("cuda"),
                       (row_of, col_of, slots, row_start, meta.n_block_rows),
                       (128, 128), meta.nnz,
                       int(np.unique(np.asarray(meta.col_of)).size),
                       torch.randn(a_g.shape[1], n, generator=gen,
                                   device="cuda"))}
    a_dw = table2["incrs-docword"].crs.to_dense()
    blk = TABLE2_BLOCK["incrs-docword"]
    bsr_dw = Q.BSR.from_dense(a_dw, (blk, blk))
    d_row_of, d_col_of, d_slots, d_rs = Q.ops.prep_bsr(bsr_dw, device="cuda")
    out["docword"] = (torch.from_numpy(a_dw).to("cuda"),
                      (d_row_of, d_col_of, d_slots, d_rs,
                       bsr_dw.n_block_rows), (blk, blk), bsr_dw.nnz_blocks,
                      int(np.unique(bsr_dw.col_idx).size),
                      torch.randn(a_dw.shape[1], n, generator=gen,
                                  device="cuda"))
    return out


def phase_plan_times(torch, Q, table2, granite, errs, launches,
                     by_launcher):
    """Both kernels at the granite operand and at docword, N = 512, in
    f32 and in bf16: median time, plain version, library call, bound;
    then the f32 dense geometry sweep (``plan_geometries``)."""
    flush = torch.empty(64 * 2 ** 20, device="cuda")     # 256 MB
    gen = torch.Generator(device="cuda").manual_seed(4)
    n = 512
    line, rows = {}, {}
    operands = _plan_operands_timed(torch, Q, table2, granite, gen, n)
    for where, (a_t, lists, blk, nnz, live_cols, b32) in operands.items():
        row_of, col_of, slots32, rs, nbr = lists
        for dt in (torch.float32, torch.bfloat16):
            f32 = dt == torch.float32
            a_in, b, slots = a_t.to(dt), b32.to(dt), slots32.to(dt)
            elem, peak = (4, F32_FLOP_PER_S) if f32 else \
                (2, BF16_TC_FLOP_PER_S)
            kernels = {
                "bsr_spmm": (
                    lambda: Q.KB.bsr_spmm(row_of, col_of, slots, b,
                                          n_block_rows=nbr, row_start=rs),
                    lambda: Q.KB.plain(row_of, col_of, slots, b,
                                       n_block_rows=nbr),
                    Q.KB.gemm_geometry(nbr, blk[0], blk[1], n, dt,
                                       nnz=slots.shape[0])),
                "dense_mm": (
                    lambda: Q.KD.dense_mm(a_in, b),
                    lambda: Q.KD.plain(a_in, b),
                    Q.KD.gemm_geometry(a_t.shape[0], n, a_t.shape[1], dt))}
            for kname, (fn, plain, geo) in kernels.items():
                nbytes, flops = _plan_work(kname, tuple(a_t.shape), n, elem,
                                           nnz, blk, live_cols)
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = flops / peak * 1e3
                ms = _time_ms(torch, fn, flush)
                plain_ms = _time_ms(torch, plain, flush, reps=10)
                library, why = None, None
                try:
                    if kname == "dense_mm":
                        library = _time_ms(torch,
                                           lambda: torch.matmul(a_in, b),
                                           flush)
                    else:
                        a_bsr = a_in.to_sparse_bsr(blk)
                        library = _time_ms(torch, lambda: a_bsr @ b, flush,
                                           reps=10)
                        del a_bsr
                except (RuntimeError, NotImplementedError) as exc:
                    why = f"{type(exc).__name__}: {str(exc)[:300]}"
                key = f"{where}/{kname}/{str(dt).replace('torch.', '')}"
                line[key] = {
                    "instance": geo.instance, "splits": geo.splits,
                    "ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
                    "flops": flops, "bound_bytes_ms": t_bytes,
                    "bound_ops_ms": t_ops, "library_ms": library,
                    "library_refused": why,
                    "achieved_tflops": flops / ms / 1e9}
                if where == "granite":
                    rows[(kname, f32)] = {
                        "instance": geo.instance, "ms": ms,
                        "plain_ms": plain_ms,
                        "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops
                        else "operations", "library_ms": library}
            del a_in, b, slots
    emit({"phase": "plan_times", "n": n,
          "library": {"dense_mm": "torch.matmul (f32 with TF32 off; bf16)",
                      "bsr_spmm": "A.to_sparse_bsr(block) @ B"},
          "bound_rates": {"float32": "f32 outside the tensor cores, 67 "
                                     "TFLOP/s", "bfloat16":
                          "bf16 tensor cores, 989 TFLOP/s"},
          "kernels": line})
    a_g, _, _, _, _, b_g = operands["granite"]
    emit({"phase": "plan_clocks", "operand": "granite", "n": n,
          "dense_f32_kernel": _clocks_under(
              torch, lambda: Q.KD.dense_mm(a_g, b_g)),
          "torch_matmul_f32": _clocks_under(
              torch, lambda: torch.matmul(a_g, b_g))})
    _gemm_sweep(torch, Q, operands, flush, n)
    out = []
    for kname in ("bsr_spmm", "dense_mm"):
        _, source, replaces = next(r for r in PLAN_KERNELS if r[0] == kname)
        r32, r16 = rows[(kname, True)], rows[(kname, False)]
        out.append({"name": kname, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[kname],
                    "launches_by_path": {
                        "engine": launches[kname],
                        "launcher_subprocesses": by_launcher[kname]},
                    "max_abs_err": errs[kname]["max_abs_err"], **r32,
                    "bf16": {**r16, "worst_row_err":
                             errs[kname + "/bf16"]["worst_row_err"]}})
    return out


def _clocks_under(torch, fn, seconds=2.0):
    """nvidia-smi's SM clock, power draw and limit, sampled every 0.25 s
    while ``fn`` runs back to back for ``seconds``."""
    import threading
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip())
            stop.wait(0.25)
    th = threading.Thread(target=sample)
    th.start()
    t_end = time.perf_counter() + seconds
    try:
        while time.perf_counter() < t_end:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        stop.set()
        th.join()
    return samples


def _gemm_sweep(torch, Q, operands, flush, n):
    """The dense instances at granite and at docword: the picked geometry
    and those of GEMM_SWEEP, each held against the plain version (f32
    within KERNEL_TOL of max|C|, bf16 row by row)."""
    for (where, dname), changes in GEMM_SWEEP.items():
        a32, _, _, _, _, b32 = operands[where]
        dt = getattr(torch, dname)
        a_t, b = a32.to(dt), b32.to(dt)
        m, k = a_t.shape
        picked = Q.KD.gemm_geometry(m, n, k, dt)
        ref = Q.KD.plain(a_t, b)
        scale = float(ref.abs().max())
        out = []
        for change in [{}] + changes:
            geo = Q.KD.gemm_geometry(m, n, k, dt, **change)

            def fn(geo=geo):
                return Q.KD._launch(a_t, b, geometry=geo)
            got = fn()
            err = float((got.float() - ref.float()).abs().max())
            if dt == torch.float32:
                check(err <= KERNEL_TOL * scale, f"dense at {where}, "
                      f"{change}: {err} > {KERNEL_TOL} * {scale}")
            else:
                check(Q.F.worst_row_error(got, ref) <= BF16_TOL,
                      f"dense bf16 at {where}, {change}")
            out.append({"change": change, "tile_n": geo.tile_n,
                        "splits": geo.splits, "stages": geo.stages,
                        "ctas": geo.tiles * geo.splits, "smem": geo.smem,
                        "ms": _time_ms(torch, fn, flush),
                        "max_abs_err": err})
        emit({"phase": "plan_geometries", "kernel": "dense_mm",
              "dtype": dname, "operand": where, "shape": [m, k], "n": n,
              "picked": picked._asdict(), "geometries": out})
        del a_t, b


def plan_path(torch, K, ops, engine_mod, table2):
    """Phases 9-11 and the profiles of the plan path; the kernels' rows."""
    from repro_torch.core.bsr import BSR
    from repro_torch.kernels import bsr_spmm as KB
    from repro_torch.kernels import dense_mm as KD
    from repro_torch.kernels import flash_attention as F
    from repro_torch.sparse import api
    from repro_torch.sparse import linear as lin_mod
    Q = types.SimpleNamespace(K=K, KB=KB, KD=KD, F=F, ops=ops, api=api,
                              lin_mod=lin_mod, BSR=BSR, engine=engine_mod)
    t0 = time.perf_counter()
    granite = _granite(Q)
    emit({"phase": "plan_granite", "linear_from_dense_host_s":
          time.perf_counter() - t0, "a_shape": list(granite[1].shape),
          "live_blocks": granite[0].meta.nnz})
    errs = phase_plan_kernels(torch, Q, table2, granite)
    launches, by_launcher, kept = phase_plan_serve(torch, Q, table2,
                                                   granite)
    for (label, fmt), bound in sorted(kept.items()):
        # the general kernels' symbols, and the GEMM core's by its source
        phase_profile(torch, engine_mod, bound, bound.shape[1],
                      workload=label, fmt=fmt,
                      kernel_keys=(f"{fmt}_kernel", f"{fmt}src"))
    del kept, bound
    torch.cuda.empty_cache()
    return phase_plan_times(torch, Q, table2, granite, errs, launches,
                            by_launcher)


# ----------------------------------------------------------------------
# Training: granite-34b's MLP (src/repro/configs/granite_34b.py: d_model
# 6144, d_ff 24576) as the student of the port's training example, W_up
# 6144 -> 24576, tanh, W_down 24576 -> 6144, at full width, once per
# format: incrs at density 0.1, section 256 and block 32 (S_DEFAULT /
# B_DEFAULT), bsr at block 128 and density 0.25 (BlockSparsity's
# default, the GRANITE operand above). A dense teacher seeded normal with
# scale 0.02; T = 512 token rows; 8 AdamW steps with the example's
# settings (lr 3e-3, no weight decay, 2 warmup steps).
TRAIN = {"d_model": 6144, "d_ff": 24576, "tokens": 512, "steps": 8,
         "scale": 0.02, "seed": 11}
TRAIN_SPECS = {"incrs": {"density": 0.1, "section": 256, "block": 32},
               "bsr": {"density": 0.25, "block": 128}}
TRAIN_KERNEL = {"incrs": "incrs_spmm", "bsr": "bsr_spmm"}
GRAD_TOL = 1e-4          # step 0: max|g - g64| <= GRAD_TOL * max|g64|
TRAIN_LAUNCHES = 3       # a step: two forwards and l2's dx (x needs none)


def _train_modules():
    from repro_torch.core.crs import CRS
    from repro_torch.core.incrs import InCRS
    from repro_torch.examples import train_unstructured as ex
    from repro_torch.kernels import bsr_spmm as KB
    from repro_torch.kernels import dense_mm as KD
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import incrs_gather as G
    from repro_torch.kernels import incrs_spmm as K
    from repro_torch.kernels import index_match_spmm as IM
    from repro_torch.kernels import ops
    from repro_torch.serve import engine
    from repro_torch.sparse import api
    from repro_torch.sparse import linear as lin_mod
    from repro_torch.sparse import pattern
    from repro_torch.spgemm import kernels as SK
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainer
    return types.SimpleNamespace(ex=ex, K=K, KB=KB, KD=KD, F=F, G=G, IM=IM,
                                 SK=SK, ops=ops, api=api, lin_mod=lin_mod,
                                 O=O, CRS=CRS, InCRS=InCRS, engine=engine,
                                 pattern=pattern, trainer=trainer)


def _zero_every_count(R):
    for mod in (R.K, R.G, R.IM, R.SK, R.KB, R.KD, R.F):
        mod.reset_launches()


def _every_count(R):
    return {**R.K.LAUNCHES, **R.G.LAUNCHES, **R.IM.LAUNCHES,
            **R.SK.LAUNCHES, **R.KB.LAUNCHES, **R.KD.LAUNCHES,
            **R.F.LAUNCHES}


def _train_data(torch):
    """The teacher's batch on the card: x (T, d_model) and y = tanh(x @
    W1) @ W2, both teacher weights seeded normal with scale 0.02."""
    g = TRAIN
    gen = torch.Generator(device="cuda").manual_seed(g["seed"])
    x = torch.randn(g["tokens"], g["d_model"], generator=gen, device="cuda")
    w1 = torch.randn(g["d_model"], g["d_ff"], generator=gen,
                     device="cuda") * g["scale"]
    w2 = torch.randn(g["d_ff"], g["d_model"], generator=gen,
                     device="cuda") * g["scale"]
    y = torch.tanh(x @ w1) @ w2
    return x, y


def _train_student(torch, R, fmt):
    """The two layers packed under the format's spec (weights drawn on the
    host from a seed, as ``Linear.init`` draws them); the packing's host
    seconds."""
    g = TRAIN
    spec = R.api.SparseSpec(fmt, **TRAIN_SPECS[fmt])
    layers, pack_s = {}, 0.0
    for i, (name, shape) in enumerate((("l1", (g["d_model"], g["d_ff"])),
                                       ("l2", (g["d_ff"], g["d_model"])))):
        w = (torch.randn(shape, generator=torch.Generator().manual_seed(
            g["seed"] + 1 + i)) * g["scale"]).numpy()
        t0 = time.perf_counter()
        layers[name] = R.api.Linear.from_dense(w, spec, device="cuda")
        torch.cuda.synchronize()
        pack_s += time.perf_counter() - t0
        del w
    return torch.nn.ModuleDict(layers), pack_s


def _dx_l2(R, fmt, lin, dyt):
    vals = lin.values.detach()
    if fmt == "incrs":
        return R.lin_mod._incrs_dx(lin.meta, vals, dyt)
    return R.lin_mod._bsr_dx(lin.meta, vals, dyt)


def _train_products(torch, R, fmt, model, x, y):
    """Each product of one step alone, on the operands the main path
    gives it: the two forwards, l2's dx, both layers' dW; the plain
    version of l2's dx on the same transposed operand; each kernel
    product's (bytes, flops) as this run's data needs them; and the
    operands themselves."""
    lm, l1, l2 = R.lin_mod, model["l1"], model["l2"]
    v1, v2 = l1.values.detach(), l2.values.detach()
    m1, m2 = l1.meta, l2.meta
    n = x.shape[0]
    with torch.no_grad():
        h = torch.tanh(R.api.apply(l1, x))
        out = R.api.apply(l2, h)
        dout = 2.0 * (out - y) / out.numel()
        dyt = dout.T.contiguous()
        dpre = _dx_l2(R, fmt, l2, dyt).T * (1 - h * h)
    if fmt == "incrs":
        def fwd(m, v, b):
            return lm._incrs_product(m.fwd_idx, v, (m.d_out, m.d_in),
                                     m.section, b)

        def dw(m, a, d):
            return lm._stripe_dw(m.fwd_idx, m.section, a, d)
        flat = torch.cat([v2.reshape(-1), v2.new_zeros(1)])
        tvals = flat.index_select(0, m2.t_gather).view(m2.bwd_idx.shape)
        bn = R.ops.default_bn(n)
        kp = m2.bwd_idx.shape[1] * m2.section
        b_pad = torch.nn.functional.pad(dyt, (0, -(-n // bn) * bn - n, 0,
                                              kp - dyt.shape[0]))

        def plain_dx():
            return R.K.plain("incrs_spmm", m2.bwd_idx, tvals, b_pad,
                             section=m2.section, bm=128, bn=bn)[:m2.d_in, :n]
        P = R.ops.PreparedOperand
        work = {k: _incrs_bound(torch, p, n)[:2] for k, p in (
            ("fwd_l1", P(m1.fwd_idx, v1, (m1.d_out, m1.d_in), m1.section)),
            ("fwd_l2", P(m2.fwd_idx, v2, (m2.d_out, m2.d_in), m2.section)),
            ("dx_l2", P(m2.bwd_idx, tvals, (m2.d_in, m2.d_out),
                        m2.section)))}
    else:
        def fwd(m, v, b):
            return lm._bsr_forward(m, lm._pad_slots(v, m), b)

        def dw(m, a, d):
            return lm._bsr_dw(m, a, d.T.contiguous())
        gi = m2.grad_index(v2.device)
        tslots = lm._scatter_slots(v2.index_select(0, gi.t_perm).transpose(
            1, 2), gi.t_vpos, len(m2.t_col_of))
        t_row_of, t_col_of, _ = m2.kernel_index_t(v2.device)

        def plain_dx():
            return R.KB.plain(t_row_of, t_col_of, tslots, dyt,
                              n_block_rows=m2.n_block_rows_t)
        blk = (m1.block, m1.block)
        work = {k: _plan_work("bsr_spmm", shape, n, 4, len(cols), blk,
                              int(np.unique(np.asarray(cols)).size))
                for k, shape, cols in (
                    ("fwd_l1", (m1.d_out, m1.d_in), m1.col_of),
                    ("fwd_l2", (m2.d_out, m2.d_in), m2.col_of),
                    ("dx_l2", (m2.d_in, m2.d_out), m2.t_col_of))}
    prods = {"fwd_l1": lambda: fwd(m1, v1, x.T),
             "fwd_l2": lambda: fwd(m2, v2, h.T),
             "dx_l2": lambda: _dx_l2(R, fmt, l2, dyt),
             "dw_l1": lambda: dw(m1, x, dpre),
             "dw_l2": lambda: dw(m2, h, dout)}
    return prods, plain_dx, work, (h, dout, dyt, dpre)


def _dx_library(torch, R, fmt, l2, dyt, flush):
    """One PyTorch call for l2's dx^T = W2 @ dy^T on the same values:
    ``torch.sparse.mm`` of W2 as CSR (incrs) or W2 as BSR @ dy^T (bsr)."""
    w2 = torch.from_numpy(np.ascontiguousarray(l2.to_dense())).to("cuda")
    try:
        if fmt == "incrs":
            a = w2.to_sparse_csr()
            return _time_ms(torch, lambda: torch.sparse.mm(a, dyt), flush,
                            reps=10), None
        a = w2.to_sparse_bsr((l2.meta.block, l2.meta.block))
        return _time_ms(torch, lambda: a @ dyt, flush, reps=3), None
    except (RuntimeError, NotImplementedError) as exc:
        return None, f"{type(exc).__name__}: {str(exc)[:300]}"


def _frozen_slots(torch, R, fmt, model):
    """Check that every pad slot (incrs) and zero tile (bsr) of the
    model's layers is exactly 0.0; returns how many there are."""
    frozen = 0
    for lin in model.values():
        vals = lin.values.detach()
        if fmt == "incrs":
            pad = lin.meta.fwd_idx < 0
        else:
            vals = R.lin_mod._pad_slots(vals, lin.meta)
            pad = torch.ones(vals.shape[0], dtype=torch.bool, device="cuda")
            pad[list(lin.meta.vpos)] = False
        frozen += int(pad.sum())
        check(bool((vals[pad] == 0).all()), f"{fmt}: pad slots and zero "
              f"tiles still 0.0")
    return frozen


def _timed_steps(torch, R, cfg, model, state, x, y, steps):
    """``steps`` AdamW steps, each split by CUDA events into forward,
    backward and optimizer; the parameters are taken from the model each
    step. Returns (losses, timings, state)."""
    timing = {k: [] for k in ("fwd_ms", "bwd_ms", "opt_ms", "step_ms",
                              "wall_ms")}
    losses = []
    for _ in range(steps):
        params = dict(model.named_parameters())
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        ev[0].record()
        loss = R.ex.mlp_loss(model, x, y)
        ev[1].record()
        grads = torch.autograd.grad(loss, list(params.values()))
        ev[2].record()
        _, state, _ = R.O.adamw_update(cfg, dict(zip(params, grads)), state,
                                       params)
        ev[3].record()
        losses.append(float(loss.detach()))
        timing["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        for key, (a, b) in (("fwd_ms", (0, 1)), ("bwd_ms", (1, 2)),
                            ("opt_ms", (2, 3)), ("step_ms", (0, 3))):
            timing[key].append(ev[a].elapsed_time(ev[b]))
        del loss, grads
    torch.cuda.synchronize()
    return losses, timing, state


def phase_train(torch, R, fmt):
    """One format: pack, hold step 0's gradients against float64 and l2's
    dx kernel against its plain version, time each product, take the
    counted steps, check the loss and the frozen slots, serve the trained
    l1, run the example as a subprocess. Returns the kernel's row
    additions and the trained student, its AdamW state and data (phase
    lifecycle takes them over)."""
    g = TRAIN
    kname = TRAIN_KERNEL[fmt]
    flush = torch.empty(64 * 2 ** 20, device="cuda")     # 256 MB
    x, y = _train_data(torch)
    model, pack_s = _train_student(torch, R, fmt)
    shapes = {k: list(lin.values.shape) for k, lin in model.items()}
    if fmt == "incrs":
        shapes.update({f"{k}_bwd_idx": list(lin.meta.bwd_idx.shape)
                       for k, lin in model.items()})
    t0 = time.perf_counter()
    grad_err = R.ex.grad_errors(model, x, y)        # float64 on the host
    oracle_s = time.perf_counter() - t0
    for k, err in grad_err.items():
        check(err <= GRAD_TOL, f"train {fmt}: {k} off float64 by {err} > "
              f"{GRAD_TOL} of its max")
    prods, plain_dx, work, (h, dout, dyt, dpre) = _train_products(
        torch, R, fmt, model, x, y)
    got, ref = prods["dx_l2"](), plain_dx()
    torch.cuda.synchronize()
    scale = max(float(ref.abs().max()), 1e-30)
    dx_err = float((got - ref).abs().max())
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
          f"train {fmt}: dx kernel finite, of the plain version's shape")
    check(dx_err <= KERNEL_TOL * scale, f"train {fmt}: dx kernel off its "
          f"plain version by {dx_err} > {KERNEL_TOL} * {scale}")
    del got, ref
    parts = {}
    for name, fn in prods.items():
        parts[name] = {"ms": _time_ms(torch, fn, flush, reps=10)}
        if name in work:
            nbytes, flops = work[name]
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / F32_FLOP_PER_S * 1e3
            parts[name].update(bytes=nbytes, flops=flops,
                               bound_ms=max(t_bytes, t_ops),
                               bound_by="bytes" if t_bytes >= t_ops
                               else "operations")
    parts["dx_l2"]["plain_ms"] = _time_ms(torch, plain_dx, flush, reps=3)
    parts["dx_l2"]["library_ms"], parts["dx_l2"]["library_refused"] = \
        _dx_library(torch, R, fmt, model["l2"], dyt, flush)
    parts["dx_l2"]["max_abs_err"] = dx_err
    # the dense outer products the live-slot dW avoids, as yardsticks
    parts["dw_l1"]["dense_matmul_ms"] = _time_ms(
        torch, lambda: x.T @ dpre, flush, reps=10)
    parts["dw_l2"]["dense_matmul_ms"] = _time_ms(
        torch, lambda: h.T @ dout, flush, reps=10)
    del h, dout, dyt, dpre, prods, plain_dx
    torch.cuda.empty_cache()

    cfg = R.O.AdamWConfig(lr=3e-3, weight_decay=0.0,
                          warmup_steps=max(2, g["steps"] // 10),
                          total_steps=g["steps"])
    state = R.O.adamw_init(cfg, dict(model.named_parameters()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_every_count(R)
    losses, timing, state = _timed_steps(torch, R, cfg, model, state, x, y,
                                         g["steps"])
    counts = {k: v for k, v in _every_count(R).items() if v}
    peak = torch.cuda.max_memory_allocated()
    check(counts == {kname: TRAIN_LAUNCHES * g["steps"]},
          f"train {fmt}: {TRAIN_LAUNCHES} launches of {kname} a step and "
          f"no other kernel, got {counts} in {g['steps']} steps")
    with torch.no_grad():
        final = float(R.ex.mlp_loss(model, x, y))
    check(final < losses[0], f"train {fmt}: loss {losses[0]} -> {final} "
          f"did not fall")
    frozen = _frozen_slots(torch, R, fmt, model)
    before = _every_count(R)[kname]
    eng, served_err = R.ex.serve_check(model["l1"],
                                       np.random.default_rng(g["seed"]),
                                       n=3, cols=192, max_wave_cols=512)
    served_launches = _every_count(R)[kname] - before
    check(served_err <= SERVE_TOL, f"train {fmt}: served l1 off float64 by "
          f"{served_err} > {SERVE_TOL} of max|C|")
    check(served_launches == eng.stats["waves"], f"train {fmt}: one "
          f"launch a wave, {served_launches} for {eng.stats['waves']}")
    served = {"requests": eng.stats["requests"], "waves": eng.stats["waves"],
              "launches": served_launches, "max_rel_err": served_err}
    del eng, flush
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.train_unstructured",
         "--format", fmt], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    if proc.returncode != 0:
        emit({"phase": "train_example", "format": fmt, "rc": proc.returncode,
              "stdout": proc.stdout[-2000:], "stderr": proc.stderr[-2000:]})
    check(proc.returncode == 0, f"train {fmt}: the example exited 0")
    emit({"phase": "train", "format": fmt, "model": "granite-34b MLP",
          "tokens": g["tokens"], "steps": g["steps"],
          "spec": TRAIN_SPECS[fmt], "values_shapes": shapes,
          "pack_s": pack_s, "oracle_s": oracle_s, "grad_err_f64": grad_err,
          "products": parts, "step_median": {
              k: statistics.median(v) for k, v in timing.items()},
          "step_times": timing, "peak_memory_bytes": peak,
          "launches": counts, "launches_per_step":
              counts.get(kname, 0) / g["steps"], "losses": losses,
          "final_loss": final, "frozen_slots": frozen,
          "served": served,
          "example_rc": proc.returncode,
          "example_tail": proc.stdout.strip().splitlines()[-3:]})
    dx = parts["dx_l2"]
    handoff = {"model": model, "state": state, "cfg": cfg, "x": x, "y": y,
               "final_loss": final, "step_median": {
                   k: statistics.median(v) for k, v in timing.items()},
               "peak_memory_bytes": peak}
    return (kname, counts.get(kname, 0), {
        k: dx[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                           "library_ms", "max_abs_err")}), handoff


def train_path(torch):
    """Phases train and lifecycle, one format after the other (phase
    lifecycle takes over the student phase train trained): each format's
    training row additions and its lifecycle launches."""
    R = _train_modules()
    out = {}
    for fmt in ("incrs", "bsr"):
        row, handoff = phase_train(torch, R, fmt)
        torch.cuda.empty_cache()
        out[fmt] = row, phase_lifecycle(torch, R, fmt, handoff)
        del handoff
        torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.train_reprune",
         "--device", "cuda"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    emit({"phase": "lifecycle_example", "rc": proc.returncode,
          "stdout": proc.stdout.strip()[-1500:],
          "stderr": proc.stderr.strip()[-1500:]})
    check(proc.returncode == 0, "the reprune example exited 0")
    return out


# ----------------------------------------------------------------------
# The lifecycle: phase train's trained student is served, re-pruned by the
# prune callback at one due step, hot-swapped into the running engine and
# trained on.
LIFECYCLE_DENSITY = {"incrs": 0.05, "bsr": 0.125}   # the due step's target
LIFECYCLE_STEPS = 2


def _latency_ms(reqs):
    lat = sorted((r.t_done - r.t_submit) * 1e3 for r in reqs)
    return {"p50": statistics.median(lat),
            "p99": lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))]}


def _operand_plain(torch, R, fmt, op, panel):
    """The plain version of the kernel a bound ``incrs`` or ``bsr`` plan
    launches, on that plan's own device operands and ``panel``."""
    if fmt == "incrs":
        prep = op._ready
        n = panel.shape[1]
        bn = R.ops.default_bn(n)
        b = torch.nn.functional.pad(panel, (
            0, -(-n // bn) * bn - n,
            0, prep.n_sections * prep.section - panel.shape[0]))
        return R.K.plain("incrs_spmm", prep.idx, prep.val, b,
                         section=prep.section, bm=128,
                         bn=bn)[:prep.shape[0], :n]
    meta = op.plan.meta
    row_of, col_of, _ = meta.kernel_index(panel.device)
    return R.KB.plain(row_of, col_of, op._ready, panel,
                      n_block_rows=meta.n_block_rows)


def _operand_work(torch, R, fmt, op, n):
    """(bytes, flops) of a bound ``incrs`` or ``bsr`` plan's kernel at
    ``n`` columns, as this operand's data needs them."""
    if fmt == "incrs":
        return _incrs_bound(torch, op._ready, n)[:2]
    meta = op.plan.meta
    return _plan_work("bsr_spmm", (meta.d_out, meta.d_in), n, 4,
                      len(meta.col_of), (meta.block, meta.block),
                      int(np.unique(np.asarray(meta.col_of)).size))


def _served_operands(torch, R, fmt, ops_by_side, panel, flush):
    """The engine's operand before and after the swap (the trained
    pattern, and the repacked stripes or block lists), each launched once
    on ``panel`` and held against its plain version on the same inputs,
    then timed with the plain version and its bound beside it."""
    kname = TRAIN_KERNEL[fmt]
    out = {}
    for side, op in ops_by_side.items():
        n0 = _every_count(R)[kname]
        got = op(panel)
        torch.cuda.synchronize()
        check(_every_count(R)[kname] == n0 + 1, f"lifecycle {fmt}: the "
              f"{side} operand launches {kname} once")
        ref = _operand_plain(torch, R, fmt, op, panel)
        check(tuple(got.shape) == tuple(ref.shape) and
              bool(torch.isfinite(got).all()), f"lifecycle {fmt}: {side} "
              f"operand's kernel finite, of the plain version's shape")
        scale = max(float(ref.abs().max()), 1e-30)
        err = float((got - ref).abs().max())
        check(err <= KERNEL_TOL * scale, f"lifecycle {fmt}: {side} "
              f"operand's kernel off its plain version by {err} > "
              f"{KERNEL_TOL} * {scale}")
        del got, ref
        nbytes, flops = _operand_work(torch, R, fmt, op, panel.shape[1])
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        out[side] = {"max_abs_err": err, "bytes": nbytes, "flops": flops,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "ms": _time_ms(torch, lambda: op(panel), flush),
                     "plain_ms": _time_ms(
                         torch, lambda: _operand_plain(torch, R, fmt, op,
                                                       panel), flush,
                         reps=3)}
    return out


def phase_lifecycle(torch, R, fmt, h):
    """Serve the trained l1 (W_up) with the first half of phase 3's
    mixed-width trace; re-prune l1 through ``make_prune_callback`` at one
    due step; launch one wave, then ``swap_pattern`` the repacked layer
    into the running engine and serve the second half; each request
    against float64 of the weight in force when its wave launched. The
    engine's operand before and after the swap against the kernel's plain
    version. Then the float64 gradient check on the new live set and 2
    AdamW steps on the repacked moments. Returns the format kernel's
    name, its launches on this path and the two operands' checks."""
    kname = TRAIN_KERNEL[fmt]
    model, state, cfg, x, y = (h[k] for k in ("model", "state", "cfg", "x",
                                              "y"))
    l1 = model["l1"]
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        loss_before = float(R.ex.mlp_loss(model, x, y))
    w_old = torch.from_numpy(l1.to_dense()).to("cuda").double()
    mask_old = torch.from_numpy(l1.pattern.mask).to("cuda")
    version_old, nnz_old = l1.pattern.version, l1.nnz
    panels = _trace(l1.d_in, seed=3)
    small, big = panels[:-1], panels[-1]
    half = len(small) // 2
    # Like traffic on both sides of the swap: the two halves of the
    # mixed widths (the width cycle repeats, so their widths match), each
    # closed by the 1,200-column request the engine splits across waves.
    sides = {"before": small[:half] + [big], "after": small[half:] + [big]}
    reqs_before = [R.engine.SpMMRequest(i, p)
                   for i, p in enumerate(sides["before"])]
    req_inflight = R.engine.SpMMRequest(len(reqs_before), small[0])
    reqs_after = [R.engine.SpMMRequest(len(reqs_before) + 1 + i, p)
                  for i, p in enumerate(sides["after"])]
    reqs = reqs_before + [req_inflight] + reqs_after

    _zero_every_count(R)
    eng = R.engine.SpMMEngine(l1, max_wave_cols=512)
    for r in reqs_before:
        eng.submit(r)
    eng.run()
    waves_before = eng.stats["waves"]
    # the due step of a schedule that lands on the target at once
    cb = R.trainer.make_prune_callback(R.pattern.PruneSchedule(
        LIFECYCLE_DENSITY[fmt], 1, warmup_frac=0.0))
    t0 = time.perf_counter()
    info = cb(1, torch.nn.ModuleDict({"l1": l1}), state)
    torch.cuda.synchronize()
    repack_s = time.perf_counter() - t0
    check(info is not None and info["layers"] == 1 and
          l1.pattern.version == version_old + 1,
          f"lifecycle {fmt}: one effective repack of l1, got {info}")
    # a wave launched before the swap keeps the operand it launched with
    eng.submit(req_inflight)
    eng.step(retire=False)
    inflight = {r.rid for r in eng._inflight.items}
    check(inflight == {req_inflight.rid}, f"lifecycle {fmt}: request "
          f"{req_inflight.rid} in flight at the swap, got {inflight}")
    old_op = eng.prep
    t0 = time.perf_counter()
    eng.swap_pattern(l1)
    swap_ms = (time.perf_counter() - t0) * 1e3
    check(eng.pattern_version == l1.pattern.version and
          eng.stats["pattern_swaps"] == 1,
          f"lifecycle {fmt}: the engine records pattern "
          f"v{l1.pattern.version}, has v{eng.pattern_version}")
    for r in reqs_after:
        eng.submit(r)
    eng.run()
    torch.cuda.synchronize()
    serve_counts = {k: v for k, v in _every_count(R).items() if v}
    check(len(eng.finished) == len(reqs) and all(r.done for r in reqs),
          f"lifecycle {fmt}: every request served")
    check(serve_counts == {kname: eng.stats["waves"]}, f"lifecycle {fmt}: "
          f"one launch of {kname} a wave, {serve_counts} for "
          f"{eng.stats['waves']} waves")
    w_new = torch.from_numpy(l1.to_dense()).to("cuda").double()
    mask_new = torch.from_numpy(l1.pattern.mask).to("cuda")
    worst = {"old": 0.0, "new": 0.0}
    for r in reqs:
        which = "old" if r.rid <= req_inflight.rid else "new"
        want = (w_old if which == "old" else w_new).T @ torch.from_numpy(
            r.b).to("cuda").double()
        got = torch.from_numpy(r.out).to("cuda")
        check(tuple(got.shape) == tuple(want.shape) and
              bool(torch.isfinite(got).all()),
              f"lifecycle {fmt} request {r.rid} finite, right shape")
        cmax = max(float(want.abs().max()), 1e-30)
        err = float((got.double() - want).abs().max())
        check(err <= SERVE_TOL * cmax, f"lifecycle {fmt} request {r.rid} "
              f"({which} weight): {err} > {SERVE_TOL} * {cmax}")
        worst[which] = max(worst[which], err / cmax)
    # the repack: survivors carried over exactly, pruned slots gone
    check(bool((mask_new <= mask_old).all()) and
          bool((w_new[mask_new] == w_old[mask_new]).all()) and
          bool((w_new[~mask_new] == 0).all()),
          f"lifecycle {fmt}: surviving values carried over, pruned slots "
          f"absent from the new values")
    pruned = int((mask_old & ~mask_new).sum())
    del w_old, w_new, mask_old, mask_new
    check(eng.stats["waves"] - waves_before - 1 == waves_before,
          f"lifecycle {fmt}: like traffic packs into as many waves on both "
          f"sides of the swap, {waves_before} and "
          f"{eng.stats['waves'] - waves_before - 1}")
    lat = {"before": _latency_ms(reqs_before),
           "after": _latency_ms(reqs_after)}
    walls = [w * 1e3 for w in eng._wave_wall_s]
    wave_ms = {"before": statistics.median(walls[:waves_before]),
               "after": statistics.median(walls[waves_before + 1:])}
    # The kernel on the operands the swap moved between (the repacked
    # ones no earlier phase gave it) against its plain version on one
    # 512-column panel, and timed; the training steps below run l1's
    # forward on the repacked operand too. These launches are outside
    # the counted path.
    flush = torch.empty(64 * 2 ** 20, device="cuda")     # 256 MB
    panel = torch.from_numpy(np.concatenate(small, axis=1)[:, :512]).to(
        "cuda")
    operands = _served_operands(torch, R, fmt,
                                {"before": old_op, "after": eng.prep},
                                panel, flush)
    del flush, panel
    # where a wave's time goes on either side of the swap: the same
    # traffic served by a fresh engine over each side's operand
    for side, op in (("before", old_op), ("after", eng.prep)):
        phase_profile(torch, R.engine, op, l1.d_in,
                      workload=f"lifecycle granite W_up, {side} the swap",
                      fmt=fmt, kernel_keys=("expand_kernel",)
                      if fmt == "incrs" else ("bsr_kernel", "bsrsrc"))
    del old_op

    t0 = time.perf_counter()
    grad_err = R.ex.grad_errors(model, x, y)        # float64, new live set
    oracle_s = time.perf_counter() - t0
    for k, err in grad_err.items():
        check(err <= GRAD_TOL, f"lifecycle {fmt}: {k} off float64 by {err} "
              f"> {GRAD_TOL} of its max")
    _zero_every_count(R)
    losses, timing, state = _timed_steps(torch, R, cfg, model, state, x, y,
                                         LIFECYCLE_STEPS)
    step_counts = {k: v for k, v in _every_count(R).items() if v}
    check(step_counts == {kname: TRAIN_LAUNCHES * LIFECYCLE_STEPS},
          f"lifecycle {fmt}: {TRAIN_LAUNCHES} launches of {kname} a step "
          f"and no other kernel, got {step_counts}")
    with torch.no_grad():
        final = float(R.ex.mlp_loss(model, x, y))
    check(all(np.isfinite(losses)) and np.isfinite(final),
          f"lifecycle {fmt}: finite losses {losses} -> {final}")
    if fmt == "incrs":
        check(final <= loss_before, f"lifecycle {fmt}: loss {final} after "
              f"the repack and {LIFECYCLE_STEPS} steps above its value "
              f"{loss_before} before the repack")
    else:
        # Halving the live blocks of a trained bsr layer costs more loss
        # than 2 steps win back, so it is held to training on: the loss
        # falls from its value just after the repack.
        check(final < losses[0], f"lifecycle {fmt}: loss not falling on "
              f"the new pattern, {losses} -> {final}")
    frozen = _frozen_slots(torch, R, fmt, model)
    peak = torch.cuda.max_memory_allocated()
    launches = eng.stats["waves"] + step_counts.get(kname, 0)
    emit({"phase": "lifecycle", "format": fmt, "model": "granite-34b MLP",
          "layer": "l1 (W_up)", "density": [nnz_old / (l1.d_in * l1.d_out),
                                            l1.density],
          "nnz": [nnz_old, l1.nnz], "pruned": pruned,
          "version": l1.pattern.version, "repack_s": repack_s,
          "swap_ms": swap_ms, "repack_info": info,
          "values_shape": list(l1.values.shape),
          "requests": [len(reqs_before), len(reqs_after)],
          "columns": [sum(p.shape[1] for p in sides[k])
                      for k in ("before", "after")],
          "waves": [waves_before, eng.stats["waves"] - waves_before - 1],
          "inflight_at_swap": sorted(inflight),
          "latency_ms": lat, "wave_ms_p50": wave_ms, "wave_ms": walls,
          "operands_512": operands, "max_rel_err": worst,
          "serve_launches": serve_counts, "oracle_s": oracle_s,
          "grad_err_f64": grad_err, "loss_before_repack": loss_before,
          "losses": losses, "final_loss": final,
          "step_median_before": h["step_median"],
          "step_median_after": {k: statistics.median(v)
                                for k, v in timing.items()},
          "step_times": timing, "step_launches": step_counts,
          "frozen_slots": frozen, "peak_memory_bytes": peak,
          "train_peak_memory_bytes": h["peak_memory_bytes"]})
    del eng
    return kname, launches, {k: {f: v[f] for f in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
        for k, v in operands.items()}


# ----------------------------------------------------------------------
# The crs plan: granite-34b's W_up^T at phase train's density times top-5 %
# activations (the regime of examples/spgemm_activations.py), through each
# route; then mesh-docword4's bound plan beside ops.spmm(A, A).
CRS_PLAN = {"density": 0.1, "rounds": 128, "tokens": 512, "keep": 307,
            "seed": 21}
CRS_ROUTES = {None: {"index_match_spmm": 1},
              "crs": {"spgemm_condense": 1, "spgemm_merge": 1},
              "incrs": {"spgemm_condense": 1, "spgemm_merge": 1}}
CRS_CALLS = 2            # the first call preps the RHS; the second hits
CRS_TOL = 1e-4           # |C - C64| <= CRS_TOL * (1 + |C64|) elementwise
DOCWORD_CALLS = 5


def _top_k_rows(R, x, k):
    """CRS of x (T, K) keeping each row's k largest |x|: top-k
    activations as a sparse B^T."""
    t, kk = x.shape
    keep = np.sort(np.argpartition(-np.abs(x), k - 1, axis=1)[:, :k],
                   axis=1)
    vals = np.take_along_axis(x, keep, axis=1)
    return R.CRS(vals.reshape(-1).astype(np.float32),
                 keep.reshape(-1).astype(np.int32),
                 np.arange(t + 1, dtype=np.int64) * k, (t, kk))


def _timed_call(torch, fn):
    """``fn()`` with its wall split: the host until it returned, the card
    from before the call to its last launch's end, the CPU time."""
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    ev0.record()
    out = fn()
    ev1.record()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return out, {"wall_ms": (t2 - t0) * 1e3, "host_ms": (t1 - t0) * 1e3,
                 "device_span_ms": ev0.elapsed_time(ev1),
                 "cpu_ms": (time.process_time() - cpu0) * 1e3}


def _c64_host(pattern, values, bt):
    """float64 C = A @ Bt^T on the host (scipy.sparse), A's values at the
    plan's slots in row-major order; and A's CSR row pointer and column
    indices."""
    import scipy.sparse as sp
    mask_a = np.ascontiguousarray(pattern.mask.T)
    m, k = mask_a.shape
    indptr = np.zeros(m + 1, np.int64)
    indptr[1:] = np.cumsum(mask_a.sum(axis=1))
    cols = np.nonzero(mask_a)[1]
    a64 = sp.csr_matrix((values.astype(np.float64), cols, indptr),
                        shape=(m, k))
    b64 = sp.csr_matrix((bt.values.astype(np.float64), bt.col_idx,
                         bt.row_ptr), shape=bt.shape)
    return (a64 @ b64.T).toarray(), indptr, cols


def phase_crs_plan(torch, R):
    """granite-34b's W_up^T (24576 x 6144, density 0.1) planned once by
    ``plan_for_operand(..., SparseSpec("crs", ...))``, times B^T = top-5 %
    activations over 512 token rows: the plan's host time, then each route
    (index matching; condense + merge for a crs and an InCRS B^T) called
    twice, the second a memo hit of the RHS prep, every C against float64
    on the host and condense + merge bitwise equal to index matching;
    counters zeroed just before and read just after. Then each kernel on
    the plan's operands against its plain version, and timed beside the
    bound and a library call. Returns the rows' additions."""
    g, t = CRS_PLAN, TRAIN
    a = (torch.randn((t["d_ff"], t["d_model"]), generator=torch.Generator()
                     .manual_seed(g["seed"])) * t["scale"]).numpy()
    x = np.random.default_rng(g["seed"]).standard_normal(
        (g["tokens"], t["d_model"])).astype(np.float32)
    bt = _top_k_rows(R, x, g["keep"])
    inc_bt = R.InCRS.from_crs(bt)
    host = {}
    t0 = time.perf_counter()
    base = R.api.plan_for_operand(a, R.api.SparseSpec(
        "crs", density=g["density"], rounds=g["rounds"]), device="cuda")
    torch.cuda.synchronize()
    host["plan_for_operand_ms"] = (time.perf_counter() - t0) * 1e3
    del a
    pat = base.pattern
    t0 = time.perf_counter()
    R.api._crs_plan_meta(pat, g["rounds"])
    host["crs_plan_meta_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    base.plan.bind(base.values)
    torch.cuda.synchronize()
    host["bind_ms"] = (time.perf_counter() - t0) * 1e3
    plans = {None: base}
    for f in ("crs", "incrs"):
        t0 = time.perf_counter()
        plans[f] = R.api.plan(R.api.SparseSpec(
            "crs", pattern=pat, rounds=g["rounds"], rhs_format=f)).bind(
                base.values)
        torch.cuda.synchronize()
        host[f"plan_and_bind_{f}_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    c64, indptr, cols = _c64_host(pat, base.values.cpu().numpy(), bt)
    oracle_s = time.perf_counter() - t0
    ref = torch.from_numpy(c64).to("cuda")
    del c64
    m, n = t["d_ff"], g["tokens"]

    _zero_every_count(R)
    outs, calls, errs = {}, {}, {}
    for f, bound in plans.items():
        rhs = inc_bt if f == "incrs" else bt
        before = _every_count(R)
        runs = []
        for _ in range(CRS_CALLS):
            out, timing = _timed_call(torch, lambda: bound(rhs))
            runs.append(timing)
        moved = {k: v - before[k] for k, v in _every_count(R).items()
                 if v != before[k]}
        want = {k: CRS_CALLS * v for k, v in CRS_ROUTES[f].items()}
        check(moved == want, f"crs plan rhs_format={f}: launches {moved} "
              f"are {want}")
        check(tuple(out.shape) == (m, n) and out.dtype == torch.float32 and
              bool(torch.isfinite(out).all()),
              f"crs plan rhs_format={f}: finite f32 ({m}, {n})")
        diff = (out.double() - ref).abs()
        check(bool((diff <= CRS_TOL * (1 + ref.abs())).all()),
              f"crs plan rhs_format={f}: max|C - C64| {float(diff.max())} "
              f"over {CRS_TOL} (rtol = atol)")
        errs[str(f)] = float(diff.max())
        outs[f] = out
        calls[str(f)] = runs
    counts = {k: v for k, v in _every_count(R).items() if v}
    for f in ("crs", "incrs"):
        check(torch.equal(outs[f], outs[None]), f"crs plan: condense + merge "
              f"(rhs_format={f}) bitwise equal to index matching")
    c_max = float(ref.abs().max())
    del outs, ref

    # each kernel on the plan's operands, as the plan launches them
    ai, av = base._ready
    bi, bv = R.api._rhs_rounds_prep(base.plan.meta, bt, ai.device)
    ai, av, bi, bv = R.ops.pad_common_rmax(ai, av, bi, bv)
    kerr, instances = _check_match(torch, R, ai, av, bi, bv,
                                   rounds=g["rounds"], bm=128,
                                   label="granite W_up^T crs plan")
    flush = torch.empty(64 * 2 ** 20, device="cuda")     # 256 MB
    kw = dict(rounds=g["rounds"], bm=128, bn=128)
    pairs = int((np.bincount(cols, minlength=t["d_model"]) *
                 np.bincount(bt.col_idx, minlength=t["d_model"])).sum())
    stripe_bytes = 4 * ai.shape[1] * ai.shape[0] * bi.shape[0]
    stripes = R.SK.spgemm_condense(ai, av, bi, bv, **kw)
    work = {"index_match_spmm": _match_work(ai, bi, pairs, m, False, n=n),
            "spgemm_condense": _match_work(ai, bi, pairs, m, True),
            "spgemm_merge": _merge_work(stripes)}
    runs = {
        "index_match_spmm": (
            lambda: R.IM.index_match_spmm(ai, av, bi, bv, **kw),
            lambda: R.IM.plain(ai, av, bi, bv, **kw)),
        "spgemm_condense": (
            lambda: R.SK.spgemm_condense(ai, av, bi, bv, **kw),
            lambda: R.SK.plain_condense(ai, av, bi, bv, **kw)),
        "spgemm_merge": (
            lambda: R.SK.spgemm_merge(stripes, bm=128, bn=128),
            lambda: R.SK.plain_merge(stripes, bm=128, bn=128))}
    a_csr = torch.sparse_csr_tensor(
        torch.from_numpy(indptr), torch.from_numpy(cols.astype(np.int64)),
        base.values.cpu(), size=(m, t["d_model"])).to("cuda")
    b_dense = torch.from_numpy(bt.to_dense().T.copy()).to("cuda")
    library = {"index_match_spmm": _time_ms(
        torch, lambda: torch.sparse.mm(a_csr, b_dense), flush, reps=10),
        "spgemm_condense": None,
        "spgemm_merge": _time_ms(torch, lambda: stripes.sum(0), flush)}
    del a_csr, b_dense
    rows, line = {}, {}
    for name, (fn, plain) in runs.items():
        ms = _time_ms(torch, fn, flush, reps=10)
        plain_ms = _time_ms(torch, plain, flush, reps=3)
        nbytes, flops = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        rows[name] = {"launches": counts.get(name, 0), "ms": ms,
                      "plain_ms": plain_ms,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations", "library_ms": library[name],
                      "max_abs_err": kerr[name], "instance": instances[name]}
        line[name] = dict(rows[name], bytes=nbytes, flops=flops)
    del stripes, flush
    emit({"phase": "crs_plan", "workload": "granite-34b W_up^T x top-5% "
          "activations", "a_shape": [m, t["d_model"]], "nnz": pat.nnz,
          "rhs_shape": list(bt.shape), "rhs_nnz": bt.nnz,
          "rounds": g["rounds"], "prep": {"a": list(ai.shape),
                                          "b": list(bi.shape)},
          "matched_pairs": pairs, "stripe_bytes": stripe_bytes,
          "host": host, "oracle_s": oracle_s, "calls": calls,
          "max_abs_err_f64": errs, "c_max": c_max, "launches": counts,
          "library": {"index_match_spmm": "torch.sparse.mm(A_csr, B)",
                      "spgemm_merge": "stripes.sum(0)"},
          "kernels": line})
    return rows


def phase_crs_plan_docword(torch, R, crs):
    """mesh-docword4 (Table IV), C = A @ A^T at R = 128 and 32: a bound crs
    plan's calls (the first preps the RHS, the rest hit its memo) beside
    ``ops.spmm(A, A)`` through the same engine on the same operands, each
    bitwise equal to it; walls split as in phase spgemm."""
    for rounds in (128, 32):
        t0 = time.perf_counter()
        ref_plan = R.api.plan_for_operand(crs, R.api.SparseSpec(
            "crs", rounds=rounds), device="cuda")
        torch.cuda.synchronize()
        plan_ms = (time.perf_counter() - t0) * 1e3
        cm_plan = R.api.plan(R.api.SparseSpec(
            "crs", pattern=ref_plan.pattern, rounds=rounds,
            rhs_format="crs")).bind(ref_plan.values)
        for engine, bound in (("reference", ref_plan),
                              ("condense_merge", cm_plan)):
            spmm, plan = [], []
            for _ in range(DOCWORD_CALLS):
                want, timing = _timed_call(torch, lambda: R.ops.spmm(
                    crs, crs, variant=engine, rounds=rounds, device="cuda"))
                spmm.append(timing)
            before = _every_count(R)
            for _ in range(DOCWORD_CALLS):
                got, timing = _timed_call(torch, lambda: bound(crs))
                plan.append(timing)
            moved = {k: v - before[k] for k, v in _every_count(R).items()
                     if v != before[k]}
            check(moved == {k: DOCWORD_CALLS for k in
                            ENGINE_LAUNCHES[engine]},
                  f"mesh-docword4 crs plan {engine} R={rounds}: launches "
                  f"{moved}")
            check(torch.equal(got, want), f"mesh-docword4 crs plan {engine} "
                  f"R={rounds}: bitwise equal to ops.spmm(A, A)")

            def med(runs, key):
                return statistics.median(r[key] for r in runs)
            emit({"phase": "crs_plan_docword", "workload": "mesh-docword4",
                  "engine": engine, "rounds": rounds, "shape": list(
                      got.shape), "nnz": crs.nnz, "plan_host_ms": plan_ms,
                  "plan_first_call": plan[0], "plan_calls": plan,
                  "spmm_calls": spmm,
                  "plan_memo_hit_wall_ms_median": med(plan[1:], "wall_ms"),
                  "spmm_wall_ms_median": med(spmm, "wall_ms"),
                  "plan_memo_hit_cpu_ms_median": med(plan[1:], "cpu_ms"),
                  "spmm_cpu_ms_median": med(spmm, "cpu_ms")})
            del want, got
        del ref_plan, cm_plan
        torch.cuda.empty_cache()


def crs_plan_path(torch):
    """Phase crs_plan at granite and at mesh-docword4: the rows'
    additions."""
    from repro_torch.configs.paper_spmm import WORKLOADS
    from repro_torch.data import datasets
    R = _train_modules()
    rows = phase_crs_plan(torch, R)
    torch.cuda.empty_cache()
    phase_crs_plan_docword(torch, R, datasets.synthesize(
        WORKLOADS["mesh-docword4"].dataset, seed=0))
    return rows


# ----------------------------------------------------------------------
# LM serving: granite-34b through ServeEngine, prompts of FLASH_THRESHOLD
# tokens or more prefilling through the flash-attention kernel.
LM_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
LM_REPLACES = "src/repro/kernels/flash_attention.py:38"
# Against plain f32 on the same inputs: f32 max|kernel - plain| <= tol *
# max|out| over the whole output; bf16 the same bound on every query row,
# with that row's max|out| (F.worst_row_error), since the whole output's
# max comes from the first rows, which average a few keys.
LM_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
LM_FAULT_ROW = 4096           # the planted fault: key tile 0 dropped from
                              # granite's query rows at and past this one
LM_DEPTH = 4                  # granite-34b cut from 88 layers, widths kept
LM_LOGIT_TOL = 1e-3           # f32 decode logits vs teacher-forced prefill
# (label, B, S, KV, G, hd, window, soft cap): granite-34b's prefill wave,
# mixtral-8x7b's and recurrentgemma-2b's attention shapes, edge shapes.
LM_KERNEL_CASES = [
    ("granite", 2, 8192, 1, 48, 128, None, None),
    ("mixtral", 1, 8192, 8, 4, 128, 4096, None),
    ("recurrentgemma", 1, 4096, 1, 10, 256, 2048, 30.0),
] + [(f"edge_s{s}_hd{hd}", 2, s, 2, 3, hd, None, None)
     for s in (1, 63, 65, 200, 1000) for hd in (16, 64)] + [
    ("edge_window_cap", 2, 200, 2, 3, 64, 37, 6.0),
    ("edge_window", 1, 1000, 1, 4, 16, 100, None),
]


def _causal_pairs(sq, sk, window):
    """Number of (query, key) pairs the mask keeps: the work of the call."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, sk - 1)
    lo = np.zeros_like(i) if window is None else np.maximum(0, i - window + 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _drop_first_key_tile(torch, q, k, v, row0):
    """Causal attention of q's rows row0.. (B, S, 1, G, hd) over k, v
    without the keys of the first 64-key tile, in f32: what a kernel that
    skipped that tile for those rows would return."""
    b, s, _, g, hd = q.shape
    out = torch.empty(b, s - row0, g, hd, device=q.device)
    i = torch.arange(row0, s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    keep = (j <= i) & (j >= 64)
    for bi in range(b):
        kk, vv = k[bi, :, 0].float(), v[bi, :, 0].float()
        for g0 in range(0, g, 8):
            qq = q[bi, row0:, 0, g0:g0 + 8].float().transpose(0, 1)
            sc = (qq @ kk.T / hd ** 0.5).masked_fill(~keep, float("-inf"))
            out[bi, :, g0:g0 + 8] = (torch.softmax(sc, -1) @ vv).transpose(
                0, 1)
            del sc
    return out


def phase_lm_kernels(torch, F):
    """The flash kernel against its plain version on the card, f32 and
    bf16, at the model shapes and edge shapes; the worst error of each.
    At granite's wave the bf16 check is also shown a planted fault (key
    tile 0 dropped from the rows past LM_FAULT_ROW) and must reject it."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    errs, cases = {}, []
    for label, b, s, kv, g, hd, window, cap in LM_KERNEL_CASES:
        q32 = torch.randn(b, s, kv, g, hd, generator=gen, device="cuda")
        k32 = torch.randn(b, s, kv, hd, generator=gen, device="cuda")
        v32 = torch.randn(b, s, kv, hd, generator=gen, device="cuda")
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
            route = F.ROUTES[dt]
            before = dict(F.ROUTE_LAUNCHES)
            out = F.flash_attention(q, k, v, window=window, soft_cap=cap)
            torch.cuda.synchronize()
            check({r: F.ROUTE_LAUNCHES[r] - before[r] for r in before} ==
                  {r: int(r == route) for r in before},
                  f"flash {label} {dname} launched the {route} kernel once "
                  f"and no other")
            want = F.plain(q.float(), k.float(), v.float(), window=window,
                           soft_cap=cap)
            scale = float(want.abs().max())
            err = float((out.float() - want).abs().max())
            row_err = F.worst_row_error(out, want)
            within = (row_err <= LM_TOL[dname] if dt == torch.bfloat16
                      else err <= LM_TOL[dname] * scale)
            ok = (out.dtype == dt and tuple(out.shape) == tuple(q.shape) and
                  bool(torch.isfinite(out).all()) and within)
            case = {"case": label, "dtype": dname, "kernel": route,
                    "shape": [b, s, kv, g, hd], "window": window,
                    "soft_cap": cap, "max_abs_err": err,
                    "max_abs_out": scale, "worst_row_error": row_err,
                    "ok": ok}
            check(ok, f"flash kernel {label} {dname}: err {err} (worst "
                  f"row {row_err}) over {LM_TOL[dname]} (max|out| {scale})")
            if label == "granite" and dt == torch.bfloat16:
                bad = out.clone()
                bad[:, LM_FAULT_ROW:, 0] = _drop_first_key_tile(
                    torch, q, k, v, LM_FAULT_ROW).to(dt)
                fault = {"what": f"key tile 0 dropped from query rows >= "
                                 f"{LM_FAULT_ROW}",
                         "worst_row_error": F.worst_row_error(bad, want),
                         "whole_output_error": float(
                             (bad.float() - want).abs().max()) / scale}
                fault["rejected"] = fault["worst_row_error"] > LM_TOL[dname]
                case["planted_fault"] = fault
                check(fault["rejected"], f"the bf16 check let a planted "
                      f"fault through: {fault}")
                del bad
            cases.append(case)
            errs[f"{label}/{dname}"] = err
            del out, want
    emit({"phase": "lm_kernels", "tolerance": {
        "float32": f"max|err| <= {LM_TOL['float32']} * max|out| against "
                   f"plain f32 on the same inputs",
        "bfloat16": f"on every query row, max|err| <= "
                    f"{LM_TOL['bfloat16']} * that row's max|out|, against "
                    f"plain f32 on the same inputs"}, "cases": cases})
    return errs


def _lm_requests(E, vocab, n, length, max_new, rid0, seed):
    rng = np.random.default_rng(seed)
    return [E.Request(rid0 + i, rng.integers(0, vocab, length).astype(
        np.int32), max_new=max_new) for i in range(n)]


def _serve_lm(torch, E, model, reqs):
    eng = E.ServeEngine(model, n_slots=4, cache_dtype=torch.bfloat16, seed=0)
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def phase_lm_serve(torch, F, L):
    """granite-34b at full width, depth cut to LM_DEPTH, weights seeded on
    the card: ServeEngine(n_slots=4) serves 2 requests of 8,192 tokens (one
    flash wave) then 4 of 512 (a dense-branch wave), 16 new tokens each,
    with the flash counter at 0 just before and read after each set. Then
    the long wave under torch.profiler for the idle share, an f32 check of
    the decode logits against a teacher-forced prefill, and the launcher
    as a subprocess."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    full = L.configs.get("granite-34b")
    cfg = dataclasses.replace(full, n_layers=LM_DEPTH)
    t0 = time.perf_counter()
    model = L.M.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    v, max_new = cfg.vocab_size, 16
    long_reqs = _lm_requests(L.E, v, 2, 8192, max_new, 0, seed=1)
    short_reqs = _lm_requests(L.E, v, 4, 512, max_new, 10, seed=2)
    F.reset_launches()
    eng_l, wall_l = _serve_lm(torch, L.E, model, long_reqs)
    launches_long = F.LAUNCHES["flash_attention"]
    check(F.ROUTE_LAUNCHES["bf16_wgmma"] == launches_long,
          f"the bf16 wave ran only the bf16 kernel: {F.ROUTE_LAUNCHES}")
    eng_s, wall_s = _serve_lm(torch, L.E, model, short_reqs)
    launches = F.LAUNCHES["flash_attention"]
    for r in long_reqs + short_reqs:
        check(r.done and len(r.out) == max_new and
              all(0 <= t < cfg.padded_vocab() for t in r.out),
              f"lm request {r.rid} returned {max_new} tokens")
    check(launches_long == LM_DEPTH, f"long wave launched the flash kernel "
          f"{launches_long} times, not {LM_DEPTH} (one per layer)")
    check(launches == launches_long, f"the 512-token wave launched the "
          f"flash kernel {launches - launches_long} times, not 0")
    new_tokens = sum(len(r.out) for r in long_reqs + short_reqs)

    # Both sets again, warm (the counted run was the process's first, with
    # cuBLAS's and the allocator's first calls in it); then the long wave
    # profiled: device busy time against the warm wall (the profiler slows
    # the host).
    warm_l, warm_wall_l = _serve_lm(torch, L.E, model, _lm_requests(
        L.E, v, 2, 8192, max_new, 0, seed=1))
    warm_s, warm_wall_s = _serve_lm(torch, L.E, model, _lm_requests(
        L.E, v, 4, 512, max_new, 10, seed=2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_prof = _serve_lm(torch, L.E, model, _lm_requests(
            L.E, v, 2, 8192, max_new, 0, seed=1))
    # By kernel symbol: the flash kernels by the names the wrapper exports
    # (tested first, since a library GEMM's name may hold any word), then
    # the library GEMMs, then the rest.
    by_kind = {"flash_attention": 0.0, "gemm": 0.0, "other": 0.0}
    by_route = {r: 0.0 for r in F.KERNEL_SYMBOLS}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        key = ev.key.lower()
        route = next((r for r, sym in F.KERNEL_SYMBOLS.items()
                      if sym.lower() in key), None)
        kind = ("flash_attention" if route else
                "gemm" if any(w in key for w in ("gemm", "nvjet", "xmma",
                                                 "cutlass")) else "other")
        by_kind[kind] += us / 1e3
        if route:
            by_route[route] += us / 1e3
    busy_ms = sum(by_kind.values())
    check(busy_ms > 0, "the profiler recorded device time on the long wave")
    check(by_route["bf16_wgmma"] > 0 and by_route["f32_fma"] == 0,
          f"the profiled bf16 wave's flash time is the bf16 kernel's: "
          f"{by_route}")

    # f32: the same weights, decode logits against a teacher-forced
    # prefill over prompt + generated tokens (which runs the kernel again)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = L.M.Model(cfg32, device="meta")
    model32.load_state_dict(model.state_dict(), assign=True)
    prompts = np.stack([r.prompt for r in long_reqs])
    logits, cache = L.M.prefill_step(model32, prompts, alloc_seq=8192 + 80,
                                     cache_dtype=torch.float32)
    steps = [logits.float()]
    toks = []
    for step in range(max_new - 1):
        tok = steps[-1].argmax(-1, keepdim=True)
        toks.append(tok)
        logits, cache = L.M.decode_step(model32, tok, cache,
                                        pos=8192 + step)
        steps.append(logits.float())
    del cache
    fed = torch.cat([torch.from_numpy(prompts).to("cuda").long()] + toks, 1)
    F.reset_launches()
    with torch.no_grad():
        tf = model32(fed, mode="train")[:, 8191:].float()
    tf_launches = F.LAUNCHES["flash_attention"]
    dec = torch.stack(steps, 1)
    scale = float(tf.abs().max())
    logit_err = float((dec - tf).abs().max())
    check(tuple(dec.shape) == tuple(tf.shape) and
          bool(torch.isfinite(dec).all()), "f32 logits finite, right shape")
    check(logit_err <= LM_LOGIT_TOL * scale, f"f32 decode logits vs "
          f"teacher-forced prefill: {logit_err} > {LM_LOGIT_TOL} * {scale}")
    check(tf_launches == LM_DEPTH, "teacher-forced prefill ran the kernel")
    del tf, dec, steps, model32, model
    torch.cuda.empty_cache()

    line = _run_lm_launcher(["--arch", "granite-34b", "--smoke",
                             "--prompt-len", "8192", "--n-requests", "2",
                             "--max-new", "4"], expect_launches=2)
    def wave(eng, n, prompt, wall_s):
        return {"requests": n, "prompt": prompt, "prefill_ms": eng.prefill_ms,
                "decode_ms_median": statistics.median(eng.decode_ms),
                "wall_s": wall_s}

    emit({"phase": "lm_serve", "arch": cfg.name,
          "cut": f"n_layers {full.n_layers} -> {LM_DEPTH}; widths as "
                 f"published", "params": n_params, "param_dtype":
          cfg.param_dtype, "dtype": cfg.dtype, "init_s": init_s,
          "counted_run": {
              "long": wave(eng_l, 2, 8192, wall_l),
              "short": wave(eng_s, 4, 512, wall_s),
              "new_tokens_per_s": new_tokens / (wall_l + wall_s)},
          "warm_run": {
              "long": wave(warm_l, 2, 8192, warm_wall_l),
              "short": wave(warm_s, 4, 512, warm_wall_s),
              "new_tokens_per_s": new_tokens / (warm_wall_l + warm_wall_s)},
          "new_tokens": new_tokens,
          "flash_launches": {"long_wave": launches_long,
                             "short_wave": launches - launches_long},
          "profile_long_wave": {"wall_ms": warm_wall_l * 1e3,
                                "wall_ms_profiled": wall_prof * 1e3,
                                "device_ms_by_kind": by_kind,
                                "flash_ms_by_kernel": by_route,
                                "device_busy_ms": busy_ms,
                                "device_idle_share": 1.0 - busy_ms /
                                (warm_wall_l * 1e3)},
          "f32_check": {"max_abs_err": logit_err, "max_abs_logit": scale,
                        "tolerance": f"{LM_LOGIT_TOL} * max|logit|",
                        "teacher_forced_launches": tf_launches},
          "launcher": line})
    return launches, line["launches"]


def _run_lm_launcher(args, expect_launches):
    import re
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    line = {"cmd": " ".join(cmd[3:]), "rc": proc.returncode,
            "wall_s": time.perf_counter() - t0}
    if proc.returncode != 0:
        emit({"phase": "lm_serve", "launcher": line,
              "stdout": proc.stdout[-2000:], "stderr": proc.stderr[-2000:]})
    check(proc.returncode == 0, f"launcher {' '.join(args)} exited 0")
    m = re.search(r"kernel launches (\{.*\})", proc.stdout)
    check(m is not None, "launcher printed its kernel launches")
    line["launches"] = json.loads(m.group(1))["flash_attention"]
    check(line["launches"] == expect_launches,
          f"launcher launched the flash kernel {line['launches']} times, "
          f"not {expect_launches}")
    return line


def phase_lm_times(torch, F, errs, launches, by_launcher):
    """granite-34b's prefill wave in bf16: the kernel's median time beside
    its plain version, scaled_dot_product_attention and the bound."""
    b, s, kv, g, hd = 2, 8192, 1, 48, 128
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = (torch.randn(*shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in ((b, s, kv, g, hd), (b, s, kv, hd),
                                      (b, s, kv, hd)))
    flush = torch.empty(64 * 2 ** 20, device="cuda")     # 256 MB
    before = dict(F.ROUTE_LAUNCHES)
    ms = _time_ms(torch, lambda: F.flash_attention(q, k, v), flush)
    check(F.ROUTE_LAUNCHES["f32_fma"] == before["f32_fma"],
          "the timed bf16 calls ran the bf16 kernel only")
    q32, k32, v32 = q.float(), k.float(), v.float()
    ms_f32 = _time_ms(torch, lambda: F.flash_attention(q32, k32, v32), flush)
    del q32, k32, v32
    plain_ms = _time_ms(torch, lambda: F.plain(q, k, v), flush, reps=10)
    # SDPA in its (B, H, S, hd) layout on the same values, copied once
    fn = torch.nn.functional.scaled_dot_product_attention
    qs = q.reshape(b, s, kv * g, hd).transpose(1, 2).contiguous()
    ks, vs = (t.transpose(1, 2).contiguous() for t in (k, v))
    try:
        sdpa = lambda: fn(qs, ks, vs, is_causal=True, enable_gqa=True)  # noqa: E731
        got = sdpa()
        how = "enable_gqa=True"
    except TypeError:
        ks, vs = (t.repeat_interleave(g, dim=1) for t in (ks, vs))
        sdpa = lambda: fn(qs, ks, vs, is_causal=True)  # noqa: E731
        got = sdpa()
        how = "k/v expanded by repeat_interleave"
    ours = F.flash_attention(q, k, v).float().reshape(b, s, kv * g, hd)
    sdpa_err = float((got.float().transpose(1, 2) - ours).abs().max())
    check(sdpa_err <= 2e-2 * float(ours.abs().max()),
          f"SDPA and the kernel disagree by {sdpa_err}")
    del got, ours
    library_ms = _time_ms(torch, sdpa, flush)
    ke, ve = (t.repeat_interleave(g, dim=1) for t in (ks, vs)) \
        if ks.shape[1] != qs.shape[1] else (ks, vs)
    expanded_ms = _time_ms(torch, lambda: fn(qs, ke, ve, is_causal=True),
                           flush)
    del ke, ve
    flops = 4 * hd * b * kv * g * _causal_pairs(s, s, None)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, out, k, v
    t_ops = flops / BF16_TC_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    emit({"phase": "lm_times", "shape": [b, s, kv, g, hd],
          "dtype": "bfloat16", "ms": ms, "ms_f32_inputs": ms_f32,
          "plain_ms": plain_ms, "library": f"scaled_dot_product_attention"
          f"(is_causal=True), {how}", "library_ms": library_ms,
          "library_kv_expanded_ms": expanded_ms,
          "library_vs_kernel_max_abs_diff": sdpa_err, "flops": flops,
          "bytes": nbytes, "bound_ops_ms": t_ops, "bound_bytes_ms": t_bytes,
          "bound_share": max(t_ops, t_bytes) / ms,
          "kernel": F.KERNEL_SYMBOLS["bf16_wgmma"],
          "kernel_f32_inputs": F.KERNEL_SYMBOLS["f32_fma"],
          "achieved_tflops": flops / ms / 1e9,
          "achieved_tflops_f32_inputs": flops / ms_f32 / 1e9})
    return [{"name": "flash_attention", "route": "cuda", "source": LM_SOURCE,
             "replaces": LM_REPLACES, "launches": launches,
             "launches_by_path": {"lm_serve": launches,
                                  "launcher_subprocess": by_launcher},
             "max_abs_err": errs["granite/bfloat16"], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": library_ms}]


def lm_path(torch):
    """Phases 15-17: the LM serving path and the flash kernel's rows."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as F
    from repro_torch.models import model as M
    from repro_torch.serve import engine as E
    L = types.SimpleNamespace(configs=configs, M=M, E=E)
    errs = phase_lm_kernels(torch, F)
    torch.cuda.empty_cache()
    launches, by_launcher = phase_lm_serve(torch, F, L)
    return phase_lm_times(torch, F, errs, launches, by_launcher)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch import spgemm
    from repro_torch.configs.paper_spmm import WORKLOADS
    from repro_torch.core.crs import CRS
    from repro_torch.core.incrs import InCRS
    from repro_torch.data import datasets
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import incrs_gather as G
    from repro_torch.kernels import incrs_spmm as K
    from repro_torch.kernels import index_match_spmm as IM
    from repro_torch.serve import engine as engine_mod
    from repro_torch.spgemm import kernels as SK

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_env(torch, _build)
    table2 = {}
    for name in TABLE2:
        wl = WORKLOADS[name]
        table2[name] = InCRS.from_crs(datasets.synthesize(wl.dataset, seed=0),
                                      wl.section, wl.block)
    docword = table2["incrs-docword"]
    errs_512 = phase_kernels(torch, K, ops, InCRS, table2)
    launches = phase_serve(K, engine_mod, table2)
    phase_profile(torch, engine_mod, docword, docword.shape[1])
    rows = phase_times(torch, K, ops, table2, errs_512, launches)
    P = types.SimpleNamespace(K=K, G=G, IM=IM, SK=SK, ops=ops, spgemm=spgemm,
                              CRS=CRS, InCRS=InCRS)
    table4 = {name: datasets.synthesize(WORKLOADS[name].dataset, seed=0)
              for name in TABLE4}
    errs_dw = phase_spgemm_kernels(torch, P, table4)
    spgemm_launches = phase_spgemm(torch, P, table4)
    phase_spgemm_alloc(torch, P, table4)
    for r in rows:              # densify reaches the fused InCRS kernel too
        r["launches_by_path"] = {"serve": r["launches"],
                                 "spgemm": spgemm_launches[r["name"]]}
        r["launches"] += spgemm_launches[r["name"]]
    docword4 = table4["mesh-docword4"]
    rows += phase_spgemm_times(torch, P, docword4, InCRS.from_crs(docword4),
                               errs_dw, spgemm_launches)
    phase_spgemm_operands(torch, P, table4)
    phase_spgemm_geometries(torch, P, docword4, table4["mesh-mks4"],
                            table4["mesh-sch"])
    del table4, P
    rows += plan_path(torch, K, ops, engine_mod, table2)
    del table2, docword
    torch.cuda.empty_cache()
    for (kname, launches_train, dx), (_, launches_life, operands) in \
            train_path(torch).values():
        r = next(r for r in rows if r["name"] == kname)
        r["launches_by_path"]["train"] = launches_train
        r["launches_by_path"]["lifecycle"] = launches_life
        r["launches"] += launches_train + launches_life
        r["train_dx"] = dx
        r["lifecycle_512"] = operands
    for kname, add in crs_plan_path(torch).items():
        r = next(r for r in rows if r["name"] == kname)
        r.setdefault("launches_by_path", {"spgemm": r["launches"]})[
            "crs_plan"] = add["launches"]
        r["launches"] += add["launches"]
        r["crs_plan"] = {k: v for k, v in add.items() if k != "launches"}
    torch.cuda.empty_cache()
    rows += lm_path(torch)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi_line(), flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
