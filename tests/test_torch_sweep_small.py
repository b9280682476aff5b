"""The differential sweep of ``test_torch_sweep.py`` on its columns of
empty, one value and all -0.0: every query case of the port against the JAX package."""

import pytest

from test_torch_sweep import FILES, check_column


@pytest.mark.parametrize("name", FILES["test_torch_sweep_small"])
def test_sweep_port_equals_jax(name):
    check_column(name)
