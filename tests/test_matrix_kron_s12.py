"""Every algorithm on the kron_s12 graph vs its host reference
(cases in tests/matrix_cases.py)."""

import pytest

from matrix_cases import CHECKS, load


@pytest.fixture(scope="module")
def case():
    return load("kron_s12")


@pytest.mark.parametrize("algorithm", sorted(CHECKS))
def test_algorithm_matches_host_reference(case, algorithm):
    CHECKS[algorithm](case)
