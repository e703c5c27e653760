"""The whole-step parity tests of tests/test_torch_train_step.py with
`skip_dead_frames_train` off: every decoder stage keeps all nine frames
while training, as the reference does. Same model, batch, draws and
tolerances; one JAX jit in this file's module-scoped fixture."""

import pytest

from test_torch_train_step import (run_both, test_batch_stats_after_the_step_match_jax,  # noqa: F401
                                   test_every_gradient_leaf_matches_jax,
                                   test_every_sub_network_gets_a_gradient,
                                   test_loss_and_metrics_match_jax,
                                   test_parameters_after_the_adam_step_match_jax)


@pytest.fixture(scope="module")
def steps():
    return run_both(False)
