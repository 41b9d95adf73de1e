"""A fixture for the port's test files that drive the JAX package's
event emitters: the module counts into a JAX metrics registry of its own
and leaves the process's registry as it found it.

A registry keeps 64 label sets a metric, and a pytest worker runs many
files in one process: label sets that one file leaves behind use up the
room of the files after it (``test_torch_obs.py``
``test_a_65th_event_label_set_counts_into_overflow``).  A module imports
``own_jax_registry`` to have it apply to each of its tests.
"""

import contextlib

import pytest

import sntc_tpu.obs.metrics as jax_metrics


@contextlib.contextmanager
def jax_registry_of_its_own():
    """A fresh JAX metrics registry as the process default while the
    block runs (yielded); the one before it is put back after."""
    prev = jax_metrics.set_registry(jax_metrics.MetricsRegistry())
    try:
        yield jax_metrics.registry()
    finally:
        jax_metrics.set_registry(prev)


@pytest.fixture(autouse=True, scope="module")
def own_jax_registry():
    with jax_registry_of_its_own():
        yield
