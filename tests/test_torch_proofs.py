"""The kernel proofs' harness on the CPU (``repro_torch.analysis``).

What the CPU can hold: the cases reach every edge the proofs need and
every instance of every ``.cu`` dispatch; the names match JAX's proof
matrix; the harness catches planted faults in fake kernel functions (a
write past the output, an element never written, an accumulator read
before its init, other bits on a repeat, a ring that never completes);
the plain versions the card's kernels are held against agree with JAX's
Pallas kernels; the port's lint finds what JAX's finds. The proofs
themselves run on the card (``tests/test_torch_cuda_proofs.py``).
"""
from __future__ import annotations

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
from _threads import one_thread                          # noqa: F401
import torch

from repro.analysis import grid_interp, kernel_check
from repro.analysis import lint as jlint
from repro_torch.analysis import __main__ as amain
from repro_torch.analysis import cases as C
from repro_torch.analysis import launch_check, lint, proofs as P, registry
from repro_torch.analysis import sanitizer
from repro_torch.kernels import _alloc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def all_cases():
    return C.cases()


# ----------------------------------------------------------------------
# The cases.
def test_every_dispatch_instance_is_launched(all_cases):
    assert C.uncovered(all_cases) == {}
    got = C.launched_instances(all_cases)
    for w in launch_check.WRAPPERS:
        want = C.dispatch_instances(w)
        assert want and want <= got[w], w
    assert {"kBf16Bk, 128>", "kBf16Bk, 256>", "bsr_kernel<8, T>",
            "case GENERAL_BF16:"} <= got["bsr_spmm"]
    assert got["flash_attention"] == {f"launch_f32<{i}>" for i in range(1, 5)
                                      } | {f"launch_bf16<{h}>"
                                           for h in (64, 128, 192, 256)}


def test_a_missing_instance_is_reported(all_cases):
    """Drop the cases of the general gather: the gap is named."""
    cs = [c for c in all_cases if not (c.wrapper == "incrs_gather" and
                                       c.name.endswith("_general"))]
    assert C.uncovered(cs) == {"incrs_gather": {"GENERAL = 0"}}
    found = amain.static_findings(cs)
    assert [f.rule for f in found] == [launch_check.RULE_INSTANCE]


REQUIRED = {  # per wrapper: the edges the issue lists, by case name
    "incrs_spmm": {"ragged_m", "ragged_n1", "ragged_n130", "ragged_k",
                   "empty_rows_and_sections", "all_zero", "smax1",
                   "smax_max_expand", "trips1", "trips2", "trips3",
                   "edge_m_ragged_n128", "edge_skewed_n384"},
    "incrs_spmm_pipelined": {"cpl1", "cluster1", "trips4",
                             "smax_max_pipelined"},
    "incrs_spmm_reuse": {"smax_max_reuse", "ragged_n130", "n260"},
    "incrs_gather": {"ragged_m", "empty_rows_and_sections", "all_zero",
                     "smax1", "base_general"},
    "index_match_spmm": {"rounds_of_one_slot", "rmax1", "rmax_eq_r",
                         "ragged_m", "ragged_n", "empty_rows_and_rounds",
                         "all_zero", "repeated_index", "r300_general",
                         "trips5", "trips6", "edge_mn_ragged_a_ne_b"},
    "spgemm_condense": {"chunk_trips2", "chunk_trips5", "chunk_trips6",
                        "repeated_index_general"},
    "spgemm_merge": {"one_round", "plane_off_4", "base_general", "trips4",
                     "trips5"},
    "bsr_spmm": {"general_tm1_n1", "general_tm2_n129",
                 "f32_split_k_one_tile", "bf16_split_k_one_tile",
                 "f32_fast_empty_rows", "all_zero", "edge_split_k",
                 "edge_skewed"},
    "dense_mm": {"general_n1", "general_n129", "f32_split_k_one_tile",
                 "bf16_trips5"},
    "flash_attention": {"sq_lt_sk_f32", "sq_gt_sk_bf16", "ragged_len_bf16",
                        "window_skips_tiles_bf16", "gqa10_hd256_cap_bf16",
                        "hd128_cap_f32", "trips3_bf16"},
}


def test_the_cases_reach_each_listed_edge(all_cases):
    names = {}
    for c in all_cases:
        names.setdefault(c.wrapper, set()).add(c.name)
    for w, want in REQUIRED.items():
        assert want <= names[w], (w, want - names[w])
    # GQA groups 1, 4, 7 and 10; head dims 64, 128, 256
    fl = [c for c in all_cases if c.wrapper == "flash_attention"]
    assert {1, 4, 7, 10} <= {c.shape["g"] for c in fl}
    assert {64, 128, 192, 256} <= {c.shape["hd"] for c in fl}
    assert any(c.args["soft_cap"] and c.shape["hd"] == 256 for c in fl)
    # the split-K cases: every partition one K tile
    for c in all_cases:
        if "split_k_one_tile" in c.name:
            assert c.geometry.splits > 1 and c.trips == 1, c.id
    # smax at the shared-memory limit: one more does not launch
    for w in C.INCRS:
        c = next(c for c in all_cases if c.wrapper == w and
                 c.name.startswith("smax_max_"))
        s = c.shape["smax"]
        with pytest.raises(ValueError):
            from repro_torch.kernels import incrs_spmm as K
            K.launch_geometry(w, c.shape["n"], s + 1, s + 1, m=8)


def test_each_ring_has_its_trip_counts(all_cases):
    by = {}
    for c in all_cases:
        if c.trips:
            by.setdefault(c.wrapper, {}).setdefault(c.stages, set()).add(
                c.trips)
    assert set(by) == set(P.KERNELS) - {"incrs_gather"}
    for w, depths in by.items():
        assert any({1, 2, s, s + 1} <= t for s, t in depths.items()), \
            (w, depths)


def test_the_cases_are_seeded(all_cases):
    again = C.cases(seed=0)
    assert [c.id for c in again] == [c.id for c in all_cases]
    a = next(c for c in all_cases if c.id == "dense_mm/f32_fast")
    b = C.cases(["dense_mm"], seed=1)[0]
    assert not np.array_equal(a.arrays["a"], b.arrays["a"])
    with pytest.raises(ValueError, match="unknown"):
        C.cases(["nope"])


# ----------------------------------------------------------------------
# Names: JAX's matrix.
def test_kernels_properties_and_rules_match_jax():
    assert P.KERNELS == grid_interp.KERNELS
    assert P.PROPERTIES == grid_interp.PROPERTIES
    assert set(P.GRID_RULES) == set(grid_interp.RULES)
    jdma = {v for k, v in vars(kernel_check).items()
            if k.startswith("RULE_DMA")}
    assert set(P.DMA_RULES) == jdma
    assert set(launch_check.WRAPPERS) == set(P.KERNELS)


def test_the_registry_merges_every_family():
    rules = registry.all_rules()
    assert set(P.RULES) <= set(rules)
    assert set(launch_check.RULES) <= set(rules)
    assert set(lint.RULE_DESCRIPTIONS) <= set(rules)
    assert set(sanitizer.RULE_OF_TOOL.values()) <= set(rules)
    old = dict(registry.FAMILIES)
    try:
        registry.FAMILIES["clash"] = {P.RULE_OOB: "something else"}
        with pytest.raises(ValueError, match="collision"):
            registry.all_rules()
    finally:
        registry.FAMILIES.clear()
        registry.FAMILIES.update(old)


# ----------------------------------------------------------------------
# Planted faults in fake kernel functions.
CASE = "dense_mm/f32_fast"


def _clean(case, t):
    want = P.call_plain(case, t)
    out = _alloc.empty(want.shape, want.dtype, want.device)
    return out.copy_(want)


def _past(case, t):
    out = _clean(case, t)
    torch.as_strided(out, (out.numel() + 1,), (1,))[-1] = 0.0
    return out


def _hole(case, t):
    want = P.call_plain(case, t)
    out = _alloc.empty(want.shape, want.dtype, want.device)
    out.view(-1)[1:] = want.view(-1)[1:]
    return out


def _before_init(case, t):
    want = P.call_plain(case, t)
    out = _alloc.empty(want.shape, want.dtype, want.device)
    return out.add_(want)


_NOISE = iter(range(1, 1000))


def _other_bits(case, t):
    out = _clean(case, t)
    out.view(-1)[7] += next(_NOISE) * 1e-3
    return out


@pytest.mark.parametrize("fake,rules", [
    (_clean, set()),
    (_past, {P.RULE_OOB}),
    (_hole, {P.RULE_COVERAGE}),
    (_before_init, {P.RULE_ACC_INIT}),
    (_other_bits, {P.RULE_RACE}),
])
def test_the_harness_catches_planted_faults(all_cases, fake, rules):
    case = next(c for c in all_cases if c.id == CASE)
    got = {f.rule for f in P.prove_case(case, "cpu", call=fake).findings}
    assert rules <= got and (rules or not got), got


def test_a_write_before_the_output_and_into_an_input():
    case = next(c for c in C.cases(["spgemm_merge"]) if c.name == "base")

    def before(case, t):
        out = _clean(case, t)
        torch.as_strided(out, (1,), (1,), out.storage_offset() - 1)[0] = 1.
        return out

    def into_input(case, t):
        out = _clean(case, t)
        s = t["stripes"]
        torch.as_strided(s, (1,), (1,), s.storage_offset() + s.numel())[0] \
            = 2.0
        return out
    for fake in (before, into_input):
        found = P.prove_case(case, "cpu", call=fake).findings
        assert [f.rule for f in found] == [P.RULE_OOB], found


def test_a_ring_that_never_completes_is_caught_by_the_watchdog():
    """A child that starts its ring case and never finishes it: killed at
    the watchdog, the case is ``dma-wait-without-start``, and the child
    resumes with the next case, which passes."""
    ids = ["dense_mm/ring", "dense_mm/next"]
    script = (
        "import json, sys, time\n"
        f"ids = {ids!r}\n"
        "for cid in ids[int(sys.argv[-1]):]:\n"
        "    print(json.dumps({'start': cid}), flush=True)\n"
        "    if cid.endswith('ring'):\n"
        "        time.sleep(120)\n"
        "    print(json.dumps({'result': {'case': cid, 'wrapper': "
        "'dense_mm', 'findings': [], 'on_card': True}}), flush=True)\n")
    res = P.watch([sys.executable, "-c", script], ids,
                  {"dense_mm/ring": True}, timeout=3)
    assert [(r.case, [f.rule for f in r.findings]) for r in res] == [
        ("dense_mm/ring", [P.RULE_DMA_WAIT]), ("dense_mm/next", [])]
    crash = ("import json, sys\n"
             "print(json.dumps({'start': 'dense_mm/ring'}), flush=True)\n"
             "sys.exit(3)\n")
    res = P.watch([sys.executable, "-c", crash], ids[:1], {}, timeout=10)
    assert [f.rule for f in res[0].findings] == [P.RULE_OOB]


def test_the_matrix_reads_untested_without_a_card(all_cases):
    results = [P.CaseResult(c.id, c.wrapper, [], trips=c.trips)
               for c in all_cases]
    matrix = P.proof_matrix(results)
    assert list(matrix) == list(P.KERNELS)
    assert {v for row in matrix.values() for v in row.values()} == \
        {"untested"}
    card = [P.CaseResult(r.case, r.wrapper, [], trips=r.trips, on_card=True)
            for r in results]
    matrix = P.proof_matrix(card)
    assert matrix["incrs_gather"]["dma"].startswith("n/a")
    assert matrix["dense_mm"] == {p: "proved" for p in P.PROPERTIES}
    card[0].findings.append(P.Finding(card[0].case, P.RULE_COVERAGE, "x"))
    assert P.proof_matrix(card)[card[0].wrapper]["coverage"] == \
        P.RULE_COVERAGE
    # the InCRS orders disagreeing at one geometry
    a = P.CaseResult("incrs_spmm/x", "incrs_spmm", [], "aa", on_card=True)
    b = P.CaseResult("incrs_spmm_reuse/x", "incrs_spmm_reuse", [], "bb",
                     on_card=True)
    assert [f.rule for f in P.cross_order([a, b])] == [P.RULE_RACE]


def test_the_cli_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "a.json"
    assert amain.main(["--check", "--device", "cpu", "--root", ROOT,
                       "--json", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["count"] == 0 and report["device"] == "cpu"
    assert set(report["proof_matrix"]) == set(P.KERNELS)
    assert "untested" in capsys.readouterr().out
    if not torch.cuda.is_available():
        assert amain.main(["--check"]) == 2


def test_the_sanitizer_report_is_parsed():
    text = "\n".join([
        "========= COMPUTE-SANITIZER",
        "========= Invalid __global__ write of size 4 bytes",
        "=========     at ring_kernel<false>+0x100",
        "========= Warning: TMA operations are not supported by racecheck",
        "========= ERROR SUMMARY: 1 error"])
    found, notes, errors = sanitizer.parse("index_match", "memcheck", text)
    assert [f.rule for f in found] == [P.RULE_OOB] and errors == 1
    assert notes and "TMA" in notes[0]
    wide = sanitizer.by_wrapper(found)
    assert {f.case.split("/")[0] for f in wide} == {
        "index_match_spmm", "spgemm_condense", "spgemm_merge"}


# ----------------------------------------------------------------------
# The plain versions against JAX's Pallas kernels (interpret mode).
def _t(c):
    return {k: torch.from_numpy(v) for k, v in c.arrays.items()}


def _case(cid):
    w, name = cid.split("/", 1)
    return next(c for c in C.cases([w]) if c.name == name)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("wrapper", C.INCRS)
def test_incrs_plain_matches_pallas(wrapper):
    from repro.kernels import incrs_spmm as jk
    c = _case(f"{wrapper}/base")
    got = P.call_plain(c, _t(c))
    want = jk.incrs_spmm(jnp.asarray(c.arrays["idx"]),
                         jnp.asarray(c.arrays["val"]),
                         jnp.asarray(c.arrays["b"]), section=64, bm=8,
                         bn=128, interpret=True)
    _close(got, want, C.TOL_F32)


def test_gather_plain_matches_pallas():
    from repro.kernels import incrs_gather as jg
    c = _case("incrs_gather/base")
    got = P.call_plain(c, _t(c))
    want = jg.incrs_gather(jnp.asarray(c.arrays["idx"]),
                           jnp.asarray(c.arrays["val"]), section=64, bm=8,
                           interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_matched_plain_versions_match_pallas():
    from repro.kernels import index_match_spmm as jim
    from repro.spgemm import kernels as jsk
    for wrapper in ("index_match_spmm", "spgemm_condense"):
        c = _case(f"{wrapper}/trips2")
        args = [jnp.asarray(c.arrays[k]) for k in ("a_idx", "a_val",
                                                   "b_idx", "b_val")]
        fn = jim.index_match_spmm if wrapper == "index_match_spmm" \
            else jsk.spgemm_condense
        want = fn(*args, rounds=32, bm=8, bn=64, interpret=True)
        _close(P.call_plain(c, _t(c)), want, C.TOL_F32)
    c = _case("spgemm_merge/base")
    want = jsk.spgemm_merge(jnp.asarray(c.arrays["stripes"]), bm=32, bn=64,
                            interpret=True)
    np.testing.assert_array_equal(P.call_plain(c, _t(c)).numpy(),
                                  np.asarray(want))


def test_gemm_plain_versions_match_pallas():
    from repro.kernels import bsr_spmm as jb
    from repro.kernels import ops as jops
    c = _case("bsr_spmm/f32_fast")
    a = c.arrays
    want = jb.bsr_spmm(jnp.asarray(a["row_of"]), jnp.asarray(a["col_of"]),
                       jnp.asarray(a["values"]), jnp.asarray(a["b"]),
                       n_block_rows=c.args["n_block_rows"], bn=64,
                       interpret=True)
    _close(P.call_plain(c, _t(c)), want, C.TOL_F32)
    c = _case("dense_mm/f32_fast")
    want = jops.dense_mm(jnp.asarray(c.arrays["a"]),
                         jnp.asarray(c.arrays["b"]), interpret=True)
    _close(P.call_plain(c, _t(c)), want, C.TOL_F32)


def test_flash_plain_matches_pallas():
    from repro.kernels import ops as jops
    for cid in ("flash_attention/ragged_len_f32",
                "flash_attention/hd128_cap_f32"):
        c = _case(cid)
        a = c.arrays
        want = jops.flash_mha(jnp.asarray(a["q"]), jnp.asarray(a["k"]),
                              jnp.asarray(a["v"]), window=c.args["window"],
                              soft_cap=c.args["soft_cap"], interpret=True)
        _close(P.call_plain(c, _t(c)), want, C.TOL_F32)


# ----------------------------------------------------------------------
def test_port_lint_finds_what_jax_lint_finds_on_the_port():
    def key(fs):
        return sorted((f.path, f.line, f.rule) for f in fs
                      if f.path.startswith("src/repro_torch/"))
    assert key(lint.lint_tree(ROOT)) == key(jlint.lint_tree(ROOT))


def test_port_lint_rules_fire():
    src = ("def f(x):\n    assert x > 0\n"
           "    if __debug__:\n        raise ValueError('x')\n"
           "    assert x, ValueError('y')\n"
           "    return ops.incrs_spmm(x) + bsr_matmul(x)\n")
    got = {(f.line, f.rule) for f in lint.lint_source(src, "m.py")}
    want = {(f.line, f.rule) for f in jlint.lint_source(
        src, "m.py", rules=tuple(lint.ALL_RULES))}
    assert got == want
    assert {r for _, r in got} == set(lint.ALL_RULES)


def test_a_device_the_sanitizer_does_not_support_is_a_note():
    text = ("========= COMPUTE-SANITIZER\n"
            "========= Error: Device not supported. Please refer to the "
            "\"Supported Devices\" section\n"
            "========= Program hit cudaErrorUnknown (error 999)\n"
            "========= ERROR SUMMARY: 3 errors\n")
    found, notes, errors = sanitizer.parse("dense_mm", "racecheck", text)
    assert found == [] and errors is None
    assert notes == ["racecheck cannot run here: Error: Device not "
                     "supported. Please refer to the \"Supported Devices\" "
                     "section"]


def test_the_general_match_instance_counts_its_ctas_from_shared_memory():
    """At R = 300 the general instance's round window (154 KB) leaves one
    CTA an SM, not the two its launch bound allows (a fault the proofs'
    occupancy check found on the card)."""
    from repro_torch.kernels import index_match_spmm as IM
    big = IM.match_geometry(16, 16, 2, 4, 4, 300)
    small = IM.match_geometry(16, 16, 2, 4, 4, 128, instance="general")
    assert big.instance == small.instance == "general"
    assert IM.assumed_ctas(big) == 1 and IM.assumed_ctas(small) == 2
    rep = launch_check.launch_report("index_match_spmm", on_card=False,
                                     m=16, n=16, n_rounds=2, rmax_a=4,
                                     rmax_b=4, rounds=300)
    assert rep.assumed_ctas == 1
