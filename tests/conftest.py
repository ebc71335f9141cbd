"""Test configuration.

The suite runs on the JAX CPU backend with 8 virtual devices (the
distributed tests build meshes over them). Tests marked ``gpu`` need an
NVIDIA GPU and skip without one; ``pytest -m gpu`` leaves the backend to
JAX, so on a machine with a GPU they run on it (chip_smoke.py runs them in
process).
"""

import os

import jax
import numpy as np
import pytest

from essentials_tpu.formats.csr import Csr
from essentials_tpu.graph import build_graph
from essentials_tpu.io.sample import sample_csr
from essentials_tpu.io import generate


def pytest_configure(config):
    if config.getoption("markexpr") != "gpu":
        os.environ.setdefault("XLA_FLAGS",
                              "--xla_force_host_platform_device_count=8")
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture(scope="session")
def sample_graph():
    """The reference's canonical 4-vertex fixture (io/sample.hxx)."""
    return build_graph(sample_csr(), directed=True, weighted=True)


@pytest.fixture(scope="session")
def chesapeake_csr():
    path = os.path.join(os.path.dirname(__file__), "..", "datasets",
                        "chesapeake.mtx")
    from essentials_tpu.io import load_graph_file
    return load_graph_file(path, cache=False)


@pytest.fixture(scope="session")
def chesapeake(chesapeake_csr):
    return build_graph(chesapeake_csr, directed=False, weighted=False)


@pytest.fixture(scope="session")
def random_graph_csr():
    """Mid-size weighted random graph for property tests."""
    coo = generate.uniform_random(200, 5, seed=7, undirected=True, weighted=True)
    return Csr.from_coo(coo)


@pytest.fixture(scope="session")
def random_graph(random_graph_csr):
    return build_graph(random_graph_csr, directed=False, weighted=True)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX runs on a GPU."""
    if request.node.get_closest_marker("gpu") and \
            jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (python3 chip_smoke.py runs these)")
