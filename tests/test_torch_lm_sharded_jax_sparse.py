"""The sharded block-sparse FFN (granite-34b"s smoke config, blocks of 16,
half of them zeroed) against the JAX package"s one-device model:
three sharded train steps and a sharded prefill with decode steps, on
JAX"s weights and inputs, at the bounds ``tests/_sharded_jax.py`` states.
"""
import pytest
from _threads import one_thread                          # noqa: F401
from _sharded_jax import check_serve, check_step

CASES = ("granite_sparse",)


@pytest.mark.parametrize("case", CASES)
def test_sharded_steps_match_jax_one_device(case):
    check_step(case)


@pytest.mark.parametrize("case", CASES)
def test_sharded_prefill_and_decode_match_jax(case):
    check_serve(case)
