"""Weights under which a recurrent mixer's state carries its output.

The JAX init (``Builder``: matrices normal(0, 0.02), ``a_log`` =
``a_param`` = ``dt_bias`` = 0, ``d_skip`` = 1) leaves an SSD layer's
output at about 3e-5 (mostly ``d_skip * x``) and an RG-LRU layer's at about
4e-5, below a tolerance of 1e-4, and a state that decays within a step or
two. The tests that hold the SSD and the RG-LRU against JAX draw the
mixers' leaves here instead: the matrices at 1/sqrt(fan_in), the decay
parameters so that a step keeps about 0.9-0.99 of the state, so that a
mixer that dropped its state, or a term of its update, fails them.

``from _recurrent_draw import draw_mixer_leaf, MIXER_LEAVES`` (numpy only:
the card tests, which import no JAX, use it too).
"""
import numpy as np

# the SSD's and the RG-LRU's leaves (no other layer uses these names)
MIXER_LEAVES = frozenset({
    "w_x", "w_z", "w_bc", "w_dt", "dt_bias", "a_log", "d_skip", "conv_w",
    "w_out", "w_in", "w_gate_branch", "w_rg", "w_ig", "a_param"})


def draw_mixer_leaf(name, shape, rng, d_skip=None):
    """A float32 value of mixer leaf ``name`` of ``shape`` (a leaf stacked
    over groups keeps its matrix in the last two axes):

    * matrices, ``conv_w`` included: normal(0, 1/sqrt(fan_in)), fan_in the
      second-last axis;
    * SSD ``dt_bias`` uniform(-3, -1) and ``a_log`` uniform(-3, -1.5): on
      unit-scale inputs dt = softplus(x w_dt + dt_bias) is about 0.05-0.3
      and exp(a_log) 0.05-0.22, so exp(-dt exp(a_log)) is 0.93-0.998;
    * RG-LRU ``a_param`` uniform(-6, -3.5): a = exp(-8 r (exp(a_param) +
      1e-3)) is 0.88-0.986 at r ~ 0.5;
    * ``d_skip`` normal(0, 0.5), or the constant ``d_skip`` when given (0:
      the state alone carries the output).
    """
    if name == "dt_bias":
        v = rng.uniform(-3.0, -1.0, shape)
    elif name == "a_log":
        v = rng.uniform(-3.0, -1.5, shape)
    elif name == "a_param":
        v = rng.uniform(-6.0, -3.5, shape)
    elif name == "d_skip":
        v = (rng.normal(0.0, 0.5, shape) if d_skip is None
             else np.full(shape, d_skip))
    elif name in MIXER_LEAVES:
        v = rng.normal(0.0, 1.0 / np.sqrt(shape[-2]), shape)
    else:
        raise KeyError(f"{name!r} is not a recurrent mixer's leaf")
    return np.asarray(v, np.float32)
