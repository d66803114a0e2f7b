"""The port's launch check (``analysis.launch_check``) on the CPU.

Every wrapper's launch through ``check_launch`` at the shapes the port
runs: the three InCRS orders on the Table II operands' stripes at N = 512;
the gather, index matching, condense and merge on the Table IV operands
(rounds at R = 128 and 32); dense and BSR at granite-34b's MLP
(24576 x 6144, block 128, density 0.25), f32 and bf16; training's InCRS
stripes; flash attention at granite's prefill wave. Then the refusals each
rule must give, the notes of the rules a CPU cannot run (no ptxas log, no
card), the register rule on a ptxas log, and a swap to an operand whose
launch the check refuses: it raises and the old operand keeps serving.
No JAX import: the check is the port's alone.
"""
from functools import lru_cache

import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401

torch = pytest.importorskip("torch")

from repro_torch.analysis import launch_check as L        # noqa: E402
from repro_torch.configs.paper_spmm import WORKLOADS      # noqa: E402
from repro_torch.core.incrs import InCRS                  # noqa: E402
from repro_torch.data import datasets                     # noqa: E402
from repro_torch.kernels import _build                    # noqa: E402
from repro_torch.kernels import incrs_spmm as K           # noqa: E402
from repro_torch.kernels import index_match_spmm as IM    # noqa: E402
from repro_torch.kernels import ops                       # noqa: E402
from repro_torch.serve.engine import SpMMEngine, SpMMRequest  # noqa: E402
from repro_torch.sparse import SparseSpec                 # noqa: E402
from repro_torch.sparse.api import plan                   # noqa: E402

TABLE2 = ("incrs-docword", "incrs-amazon", "incrs-belcastro",
          "incrs-norris", "incrs-mks")
TABLE4 = ("mesh-amazon4", "mesh-docword4", "mesh-mks4", "mesh-norris4",
          "mesh-arenas", "mesh-bates", "mesh-gleich", "mesh-sch")
ORDERS = ("incrs_spmm", "incrs_spmm_reuse", "incrs_spmm_pipelined")
CPU = dict(on_card=False)


@lru_cache(maxsize=None)
def _crs(name):
    return datasets.synthesize(WORKLOADS[name].dataset, seed=0)


@lru_cache(maxsize=None)
def _stripes(name, pad):
    """(M padded, n_sections, smax, section) of a workload's section
    stripes as ``ops.prepare_incrs`` preps them."""
    wl = WORKLOADS[name]
    prep = ops.prepare_incrs(InCRS.from_crs(_crs(name), wl.section,
                                            wl.block), pad_rows_to=pad,
                             device="cpu")
    return tuple(prep.idx.shape) + (prep.section,)


@lru_cache(maxsize=None)
def _rounds(name, rounds):
    crs = _crs(name)
    _, counts = ops.round_groups(crs, rounds)
    return -(-crs.shape[0] // 128) * 128, counts.shape[1], int(counts.max())


def _clean(report):
    """Nothing but the notes of the rules a CPU without a build cannot
    run."""
    assert report.violations == [], report.violations
    assert any(n.startswith("registers: no ptxas log") for n in report.notes)
    assert any(n.startswith("occupancy: no CUDA card") for n in report.notes)


# ----------------------------------------------------------------------
# Every wrapper at the port's own shapes.
@pytest.mark.parametrize("name", TABLE2)
@pytest.mark.parametrize("kernel", ORDERS)
def test_incrs_orders_on_table2(name, kernel):
    m, n_sections, smax, section = _stripes(name, 128)
    rep = L.launch_report(kernel, m=m, n=512, n_sections=n_sections,
                          smax=smax, section=section, **CPU)
    _clean(rep)
    assert rep.launch.geometry == K.launch_geometry(kernel, 512, smax,
                                                    section, m=m)
    assert rep.launch.smem <= L.SMEM_LIMIT
    assert rep.assumed_ctas >= 1


@pytest.mark.parametrize("stripes", [(24576, 24, 51), (6144, 96, 52),
                                     (24576, 24, 27)],
                         ids=["l1", "l2", "l1-repacked"])
@pytest.mark.parametrize("kernel", ORDERS)
def test_incrs_orders_on_training_stripes(stripes, kernel):
    m, n_sections, smax = stripes
    _clean(L.launch_report(kernel, m=m, n=512, n_sections=n_sections,
                           smax=smax, section=256, **CPU))


@pytest.mark.parametrize("name", TABLE4)
def test_spgemm_wrappers_on_table4(name):
    m8, n_sections, smax, section = _stripes(name, 8)
    _clean(L.launch_report("incrs_gather", m=m8, n_sections=n_sections,
                           smax=smax, section=section, **CPU))
    for rounds in (128, 32):
        mp, n_rounds, rmax = _rounds(name, rounds)
        for kernel in ("index_match_spmm", "spgemm_condense"):
            rep = L.launch_report(kernel, m=mp, n=mp, n_rounds=n_rounds,
                                  rmax_a=rmax, rmax_b=rmax, rounds=rounds,
                                  **CPU)
            _clean(rep)
            assert rep.launch.geometry.instance == "ring"
        assert L.check_matched_config(
            "merge", m=mp, n=mp, n_rounds=n_rounds, rmax_a=rmax,
            rmax_b=rmax, rounds=rounds, **CPU) == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_wrappers_at_granite(dtype):
    _clean(L.launch_report("dense_mm", m=24576, n=512, k=6144, dtype=dtype,
                           **CPU))
    _clean(L.launch_report("bsr_spmm", n_block_rows=192, bm=128, bk=128,
                           n=512, nnz=2304, dtype=dtype, **CPU))
    _clean(L.launch_report("bsr_spmm", n_block_rows=14, bm=50, bk=50, n=512,
                           nnz=300, dtype=dtype, **CPU))


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 128),
                                      (torch.float32, 128),
                                      (torch.bfloat16, 256)])
def test_flash_at_granite_wave(dtype, hd):
    _clean(L.launch_report("flash_attention", batch=2, sq=8192, sk=8192,
                           kv=1, g=48, hd=hd, dtype=dtype, **CPU))


def test_every_wrapper_is_covered():
    assert set(L.WRAPPERS) == {
        "incrs_spmm", "incrs_spmm_reuse", "incrs_spmm_pipelined",
        "incrs_gather", "index_match_spmm", "spgemm_condense",
        "spgemm_merge", "dense_mm", "bsr_spmm", "flash_attention"}
    with pytest.raises(ValueError, match="unknown wrapper"):
        L.check_launch("nope", m=1)


# ----------------------------------------------------------------------
# The refusals.
DOC = dict(m=768, n=512, n_sections=47, smax=33, section=256)


@pytest.mark.parametrize("kernel,knobs,rule", [
    ("incrs_spmm_reuse", {"tpr": 96}, L.RULE_INSTANCE),
    ("incrs_spmm_reuse", {"tpr": 16}, L.RULE_INSTANCE),
    ("incrs_spmm", {"rows": 9}, L.RULE_INSTANCE),
    ("incrs_spmm_pipelined", {"warps": 40}, L.RULE_INSTANCE),
    ("incrs_spmm_pipelined", {"cols_per_lane": 4}, L.RULE_INSTANCE),
    ("incrs_spmm_pipelined", {"cluster": 16, "warps": 8}, L.RULE_GRID),
])
def test_incrs_refusals(kernel, knobs, rule):
    if knobs.get("cols_per_lane") == 4:      # no instance: built by hand
        geo = K.pipe_launch(768, 512, 33, 256, 4, 8, 2)
    else:
        geo = K.launch_geometry(kernel, 512, 33, 256, m=768, **knobs)
    vs = L.check_launch(kernel, geometry=geo, **DOC, **CPU)
    assert rule in {v.rule for v in vs}, vs


def test_shared_memory_and_grid_refusals():
    big = dict(m=768, n=512, n_sections=1, smax=7000, section=8192)
    vs = L.check_launch("incrs_spmm_reuse", **big, **CPU)
    assert [v.rule for v in vs] == [L.RULE_SMEM]
    assert L.check_launch("incrs_spmm", **big, **CPU) == []
    vs = L.check_launch("incrs_spmm", **dict(big, smax=16000,
                                             section=16384), **CPU)
    assert [v.rule for v in vs] == [L.RULE_SMEM]
    vs = L.check_launch("bsr_spmm", n_block_rows=14, bm=50, bk=50,
                        n=10 ** 7, nnz=300, dtype=torch.float32, **CPU)
    assert [v.rule for v in vs] == [L.RULE_GRID]
    vs = L.check_launch("dense_mm", m=128, n=128, k=128, splits=70_000,
                        dtype=torch.float32, **CPU)
    assert [v.rule for v in vs] == [L.RULE_INSTANCE]
    vs = L.check_launch("flash_attention", batch=1, sq=64, sk=64, kv=1, g=1,
                        hd=264, dtype=torch.bfloat16, **CPU)
    assert [v.rule for v in vs] == [L.RULE_INSTANCE]
    vs = L.check_launch("index_match_spmm", m=256, n=256, n_rounds=4,
                        rmax_a=8, rmax_b=8, rounds=128, rows_per_warp=17,
                        instance="ring", **CPU)
    assert [v.rule for v in vs] == [L.RULE_INSTANCE]
    vs = L.check_matched_config("merge", m=256, n=256, n_rounds=4, rmax_a=8,
                                rmax_b=200, rounds=128, **CPU)
    assert vs[0].rule == L.RULE_GRID and "rmax" in vs[0].message


def test_a_geometry_of_another_shape_is_refused():
    geo = K.launch_geometry("incrs_spmm_pipelined", 512, 33, 256, m=768)
    assert L.check_launch("incrs_spmm_pipelined", geometry=geo, **DOC,
                          **CPU) == []
    vs = L.check_launch("incrs_spmm_pipelined", geometry=geo,
                        **dict(DOC, n=640), **CPU)
    assert [v.rule for v in vs] == [L.RULE_SHAPE]
    vs = L.check_launch("incrs_spmm", geometry=(8, 100), **DOC, **CPU)
    assert [v.rule for v in vs] == [L.RULE_SHAPE]
    g = IM.match_geometry(256, 256, 4, 8, 8, 128)
    assert L.check_launch("index_match_spmm", geometry=g, m=256, n=256,
                          n_rounds=4, rmax_a=8, rmax_b=8, rounds=128,
                          **CPU) == []
    vs = L.check_launch("index_match_spmm", geometry=g, m=512, n=256,
                        n_rounds=4, rmax_a=8, rmax_b=8, rounds=128, **CPU)
    assert L.RULE_SHAPE in {v.rule for v in vs}


def test_wrappers_raise_on_a_refused_geometry():
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(-1, 256, size=(16, 2, 4)).astype(
        np.int32))
    val = torch.ones(idx.shape)
    b = torch.zeros((512, 128))
    with pytest.raises(L.KernelConfigError, match="reuse_kernel<96>"):
        K.incrs_spmm_reuse(idx, val, b, section=256, bn=128,
                           geometry=(96, 1000))
    geo = K.launch_geometry("incrs_spmm_reuse", 128, 4, 256, m=16)
    out = K.incrs_spmm_reuse(idx, val, b, section=256, bn=128, geometry=geo)
    assert torch.equal(out, K.incrs_spmm_reuse(idx, val, b, section=256,
                                               bn=128))
    ai = torch.full((128, 4, 8), -1, dtype=torch.int32)
    av = torch.zeros(ai.shape)
    g = IM.match_geometry(256, 128, 4, 8, 8, 128)
    with pytest.raises(L.KernelConfigError, match="geometry"):
        IM.index_match_spmm(ai, av, ai, av, rounds=128, geometry=g)


# ----------------------------------------------------------------------
# The rules that read the build.
def _ptxas_log(regs, sym):
    return (f"ptxas info    : Compiling entry function '{sym}' for "
            f"'sm_90a'\nptxas info    : Used {regs} registers, 0 bytes "
            f"spill stores, 0 bytes spill loads\n")


def test_register_rule_reads_the_ptxas_log(monkeypatch):
    sym = "_ZN12_GLOBAL__N_116pipelined_kernelILi2EEEv14CUtensorMap_st"
    assert L.short_name(sym) == "pipelined_kernel<2>"
    assert L.short_name("_Z16flash_kernel_f32ILi2EEv6Params") == \
        "flash_kernel_f32<2>"
    L._report.cache_clear()
    log = _ptxas_log(80, sym) + _ptxas_log(80, sym.replace("ILi2E",
                                                           "ILi1E"))
    monkeypatch.setattr(_build, "build_log",
                        lambda name: log if name == "incrs_spmm" else "")
    monkeypatch.setattr(L, "_PTXAS", {})   # the fake entries go with it
    rep = L.launch_report("incrs_spmm_pipelined", warps=31, **DOC, **CPU)
    assert rep.registers == 80 and rep.spill_bytes == 0
    assert [v.rule for v in rep.violations] == [L.RULE_REGISTERS]
    rep = L.launch_report("incrs_spmm_pipelined", warps=8, **DOC, **CPU)
    assert rep.violations == [] and rep.registers == 80
    assert not any(n.startswith("registers") for n in rep.notes)
    assert rep.assumed_ctas == K.assumed_ctas_per_sm(
        "incrs_spmm_pipelined", rep.launch.geometry, 80)
    L._report.cache_clear()


def test_occupancy_rule_needs_a_card():
    rep = L.launch_report("incrs_spmm", **DOC, **CPU)
    assert rep.card_ctas is None and rep.assumed_ctas >= 1
    assert "occupancy: no CUDA card; rule skipped" in rep.notes


# ----------------------------------------------------------------------
# Swaps the check refuses.
SECTION = 8192                       # one section of 8,192 columns


def _stripes_operand(rows_slots):
    """A prepared (24, 8192) operand of one section whose row r holds
    ``rows_slots[r]`` non-zeros (value 1.0 at columns 0, 1, ...), and its
    dense form."""
    m = len(rows_slots)
    smax = max(1, max(rows_slots))
    idx = np.full((m, 1, smax), -1, np.int32)
    val = np.zeros((m, 1, smax), np.float32)
    dense = np.zeros((m, SECTION), np.float32)
    for r, n in enumerate(rows_slots):
        idx[r, 0, :n] = np.arange(n)
        val[r, 0, :n] = 1.0
        dense[r, :n] = 1.0
    prep = ops.PreparedOperand(torch.from_numpy(idx), torch.from_numpy(val),
                               (m, SECTION), SECTION)
    return prep, dense


def test_swap_to_a_refused_operand_keeps_the_old_one_serving():
    """Row 0 of the new operand holds 5,000 slots of its section: a CTA
    of the reuse order (8 rows at 128 columns) would stage past an SM's
    shared memory, expand's one-row CTA fits."""
    old, old_dense = _stripes_operand([3 + r for r in range(24)])
    bad, _ = _stripes_operand([5000] + [2] * 23)
    eng = SpMMEngine(old, max_wave_cols=128, variant="reuse", device="cpu")
    with pytest.raises(L.KernelConfigError, match="shared memory"):
        eng.swap_pattern(bad)
    assert eng.prep is old and eng.stats["pattern_swaps"] == 0
    rng = np.random.default_rng(4)
    b = rng.normal(size=(SECTION, 40)).astype(np.float32)
    eng.submit(SpMMRequest(0, b))
    (req,) = eng.run()
    np.testing.assert_allclose(req.out, old_dense @ b, rtol=1e-4, atol=1e-4)
    auto = SpMMEngine(old, max_wave_cols=128, device="cpu")
    auto.swap_pattern(bad)              # auto takes an order that launches
    assert auto.stats["pattern_swaps"] == 1
    assert ops.resolve_incrs(bad, 128)[0] != "reuse"


def test_swap_to_a_plan_with_a_refused_tuned_launch(monkeypatch, tmp_path):
    from repro_torch.kernels import autotune
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "c.json"))
    autotune.clear_memory_cache()
    rng = np.random.default_rng(5)
    w = np.where(rng.random((64, 32)) < 0.3, rng.normal(size=(64, 32)),
                 0.0).astype(np.float32)
    spec = SparseSpec("incrs", mask=w != 0, section=32, block=8)
    p = plan(spec, device="cpu")
    eng = SpMMEngine(p.bind(p.pack(w), device="cpu"), max_wave_cols=128,
                     device="cpu")
    old = eng.prep
    idx = p.meta.fwd_idx
    stale = autotune.TunedConfig("reuse", 128, 128, 1.0, 1.0, 0, (96, 2400),
                                 128)
    autotune._MEM[autotune.cache_key(*idx.shape, 32, 128, "cpu")] = stale
    tuned = p.__class__(p.spec, p.meta, stale)
    with pytest.raises(L.KernelConfigError):
        eng.swap_pattern(tuned.bind(p.pack(w), device="cpu"))
    assert eng.prep is old and eng.stats["pattern_swaps"] == 0
    autotune.clear_memory_cache()
