"""The differential sweep of ``test_torch_sweep.py`` on its f32 columns:
every query case of the port against the JAX package."""

import pytest

from test_torch_sweep import FILES, check_column


@pytest.mark.parametrize("name", FILES["test_torch_sweep_f32"])
def test_sweep_port_equals_jax(name):
    check_column(name)
