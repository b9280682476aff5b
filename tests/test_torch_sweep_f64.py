"""The differential sweep of ``test_torch_sweep.py`` on its columns of
all NaN and NaN payloads, f64: every query case of the port against the JAX package."""

import pytest

from test_torch_sweep import FILES, check_column


@pytest.mark.parametrize("name", FILES["test_torch_sweep_f64"])
def test_sweep_port_equals_jax(name):
    check_column(name)
