"""Port parity: a hybrid stack of attention and Mamba layers with MoE
(jamba's structure at a TINY size: 2 periods of attention + Mamba, MoE on
every second layer) against the JAX package: ``lm_forward``, the decode
sequence and ``greedy_generate`` under none and q8_0, and
``ContinuousBatcher`` with a recycled slot.  The checks and their
tolerances are ``test_torch_ssm``'s (the same cases for
reduced(xlstm-1.3b)), with the reference's decode step compiled
(``lm_forward`` op by op); they live in a file of their own so that the
two stacks' JAX programs compile on two workers.
"""
import pytest

pytest.importorskip("jax")
from test_torch_ssm import PRESETS, _check_batcher, _check_lm_paths, models  # noqa: E402,F401
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


@pytest.mark.parametrize("preset", PRESETS)
def test_lm_paths_match(models, preset):  # noqa: F811
    _check_lm_paths(models, "hybrid", preset, compiled_decode=True)


def test_continuous_batcher_matches(models):  # noqa: F811
    _check_batcher(models, "hybrid")
