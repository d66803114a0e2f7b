"""The kernel proofs on the card: every case of every wrapper
(``analysis.cases``) through ``analysis.proofs`` passes every property.

This file imports nothing of JAX: ``PYTHONPATH=src python -m pytest -q
--noconftest -m gpu tests/test_torch_cuda_proofs.py``. On a machine
without CUDA every test skips.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import cases as C                # noqa: E402
from repro_torch.analysis import proofs as P               # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def results():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the proofs launch the kernels")
    return P.run("cuda")


def test_every_case_of_every_wrapper_passes(results):
    bad = [f.format() for r in results for f in r.findings]
    assert not bad, "\n".join(bad)
    assert {r.case for r in results} == {c.id for c in C.cases()}
    assert all(r.on_card for r in results)


def test_the_incrs_orders_agree_bitwise(results):
    assert P.cross_order(results) == []
    names = {}
    for r in results:
        if r.wrapper in C.INCRS:
            names.setdefault(r.case.split("/", 1)[1], set()).add(r.wrapper)
    assert sum(len(ws) == 3 for ws in names.values()) >= 10


def test_the_matrix_is_proved(results):
    matrix = P.proof_matrix(results)
    for k, row in matrix.items():
        for p, v in row.items():
            assert v == "proved" or v.startswith("n/a"), (k, p, v)
    assert matrix["incrs_gather"]["dma"].startswith("n/a")


def test_every_ring_runs_its_trip_counts(results):
    """Each ring kernel ran cases at 1, 2, stages and stages + 1 trips of
    one ring depth, and every one of them passed."""
    by = {}
    for c in C.cases():
        if c.trips:
            by.setdefault(c.wrapper, {}).setdefault(c.stages, set()).add(
                c.trips)
    assert set(by) == set(P.KERNELS) - {"incrs_gather"}
    for w, depths in by.items():
        assert any({1, 2, s, s + 1} <= t for s, t in depths.items()), \
            (w, depths)
    ok = {r.case for r in results if not r.findings}
    assert all(c.id in ok for c in C.cases() if c.trips)


def test_a_guard_write_is_caught_on_the_card():
    """A fake launch that writes one element past its output on the card
    is a bounds finding; the clean one is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import _alloc
    case = next(c for c in C.cases(["dense_mm"]) if c.name == "f32_fast")

    def clean(case, t):
        want = P.call_plain(case, t)
        out = _alloc.empty(want.shape, want.dtype, want.device)
        return out.copy_(want)

    def past(case, t):
        out = clean(case, t)
        torch.as_strided(out, (out.numel() + 1,), (1,))[-1] = 0.0
        return out
    assert P.prove_case(case, "cuda", call=clean).findings == []
    assert [f.rule for f in P.prove_case(case, "cuda", call=past).findings] \
        == [P.RULE_OOB]
