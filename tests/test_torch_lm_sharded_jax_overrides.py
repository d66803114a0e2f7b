"""JAX's serve and train overrides on the mesh against the JAX package's
one-device model: phi3-medium-14b, internvl2-1b and recurrentgemma-2b
served under the prefill cell's overrides (a context-parallel KV cache,
``cache_seq``, and sequence-parallel attention, ``attn_q_seq``), a prefill
and decode steps at rtol = atol = 1e-4; internvl2-1b's three train steps
under its train cell's overrides (FSDP and ``attn_q_seq``), and granite-34b's
under ZeRO-1 alone (moments owned by layer), at ``tests/_sharded_jax.py``'s
bounds.
"""
import pytest
from _threads import one_thread                          # noqa: F401
from _sharded_jax import CASES, check_serve, check_step

SERVE = ("phi3_overrides", "internvl2_overrides",
         "recurrentgemma_overrides")
TRAIN = ("internvl2_train", "granite_zero1")


@pytest.mark.parametrize("case", SERVE)
def test_overrides_prefill_and_decode_match_jax(case):
    rules = CASES[case][2]
    assert rules["cache_seq"] == "model" and rules["attn_q_seq"] == "model"
    cache = check_serve(case)
    attn = next(c for c in cache if "k" in c)
    assert attn["k"].spec[1] == "model"          # the slots split


@pytest.mark.parametrize("case", TRAIN)
def test_override_steps_match_jax_one_device(case):
    check_step(case)
