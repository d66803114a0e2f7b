"""The sharded MoE FFN (mixtral-8x7b, and qwen2-moe-a2.7b under the default
rules and under the EP rule) against the JAX package"s one-device model:
three sharded train steps and a sharded prefill with decode steps, on
JAX"s weights and inputs, at the bounds ``tests/_sharded_jax.py`` states.
"""
import pytest
from _threads import one_thread                          # noqa: F401
from _sharded_jax import check_serve, check_step

CASES = ("mixtral", "qwen2", "qwen2_ep")


@pytest.mark.parametrize("case", CASES)
def test_sharded_steps_match_jax_one_device(case):
    check_step(case)


@pytest.mark.parametrize("case", CASES)
def test_sharded_prefill_and_decode_match_jax(case):
    check_serve(case)
