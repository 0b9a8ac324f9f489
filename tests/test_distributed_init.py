"""distributed.initialize idempotence semantics.

The no-op-vs-forward decision must come from explicit state/configuration
probes, never from matching JAX's exception text (which JAX may reword).
These tests monkeypatch the underlying jax.distributed.initialize to
observe exactly when it is (and is not) invoked.
"""

import pytest

import jax

from tropical_cyclone_risk_tpu.parallel import distributed


@pytest.fixture
def record_init(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.distributed, 'initialize',
                        lambda *a, **k: calls.append((a, k)))
    return calls


def test_bare_single_host_is_noop(record_init, monkeypatch):
    for v in distributed._COORD_ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setattr(distributed, '_cluster_detectable', lambda: False)
    distributed.initialize()
    distributed.initialize()            # repeat: still a no-op
    assert record_init == []


def test_already_initialized_is_noop(record_init, monkeypatch):
    monkeypatch.setattr(distributed, '_already_initialized', lambda: True)
    distributed.initialize('host0:1234', 2, 0)
    assert record_init == []


def test_explicit_args_forwarded(record_init, monkeypatch):
    monkeypatch.setattr(distributed, '_already_initialized', lambda: False)
    distributed.initialize('host0:1234', 2, 1)
    assert record_init == [(('host0:1234', 2, 1), {})]


def test_env_coordinator_forwarded(record_init, monkeypatch):
    monkeypatch.setattr(distributed, '_already_initialized', lambda: False)
    monkeypatch.setattr(distributed, '_cluster_detectable', lambda: False)
    monkeypatch.setenv('JAX_COORDINATOR_ADDRESS', 'host0:1234')
    distributed.initialize()
    assert record_init == [((None, None, None), {})]


def test_cluster_autodetect_forwarded(record_init, monkeypatch):
    for v in distributed._COORD_ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setattr(distributed, '_already_initialized', lambda: False)
    monkeypatch.setattr(distributed, '_cluster_detectable', lambda: True)
    distributed.initialize()
    assert record_init == [((None, None, None), {})]


def test_real_failure_propagates(monkeypatch):
    """A genuine initialize failure must surface, not vanish into the
    tolerated-no-op path — regardless of its message text."""
    monkeypatch.setattr(distributed, '_already_initialized', lambda: False)

    def boom(*a, **k):
        # deliberately uses the words the old substring matcher keyed on
        raise RuntimeError('coordinator must be called before once already')

    monkeypatch.setattr(jax.distributed, 'initialize', boom)
    with pytest.raises(RuntimeError):
        distributed.initialize('host0:1234', 2, 0)


def test_probes_run_against_real_jax():
    """The probes themselves work on this jax version (no AttributeError
    drift): single-process CI is not distributed-initialized and no
    cluster is detectable."""
    assert distributed._already_initialized() is False
    assert distributed._cluster_detectable() is False
