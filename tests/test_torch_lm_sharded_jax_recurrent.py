"""The sharded SSD and RG-LRU mixers (mamba2-370m, recurrentgemma-2b)
against the JAX package"s one-device model:
three sharded train steps and a sharded prefill with decode steps, on
JAX"s weights and inputs, at the bounds ``tests/_sharded_jax.py`` states.
"""
import pytest
from _threads import one_thread                          # noqa: F401
from _sharded_jax import check_serve, check_step

CASES = ("mamba2", "recurrentgemma")


@pytest.mark.parametrize("case", CASES)
def test_sharded_steps_match_jax_one_device(case):
    check_step(case)


@pytest.mark.parametrize("case", CASES)
def test_sharded_prefill_and_decode_match_jax(case):
    check_serve(case)
