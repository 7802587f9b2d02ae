"""ftanet's and TONet's training path against the JAX package's: the runs
and checks of tests/test_torch_apps.py (its module docstring gives the
sizes and tolerances), in a file of their own so that the test workers
share the two longest runs."""

import pytest

from test_torch_apps import (
    check_calibration_modes,
    check_infer,
    check_train_steps,
    check_validate,
    family_run,
)
from torch_threads import one_thread  # noqa: F401 (fixture)

FAMILIES = ("ftanet", "tonet")


@pytest.mark.parametrize("fam", FAMILIES)
def test_train_steps_match_jax(fam):
    check_train_steps(family_run(fam))


@pytest.mark.parametrize("fam", FAMILIES)
def test_validate_matches_jax(fam):
    check_validate(family_run(fam))


@pytest.mark.parametrize("fam", FAMILIES)
def test_infer_matches_jax(fam):
    check_infer(family_run(fam))


@pytest.mark.parametrize("fam", FAMILIES)
def test_calibration_modes_match_jax(fam):
    check_calibration_modes(family_run(fam))
