"""CPU checks of chip_smoke.py's logic, the float32 contraction rule and
the compile-cache rule.  The GPU halves (marked ``gpu``) skip here;
``python chip_smoke.py`` runs the same checks on the card."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent.parent))
import chip_smoke  # noqa: E402
from tropical_cyclone_risk_tpu.config import Namelist  # noqa: E402
from tropical_cyclone_risk_tpu.models import pipeline  # noqa: E402
from tropical_cyclone_risk_tpu.models.fields import synthetic_pack  # noqa: E402
from tropical_cyclone_risk_tpu.ops import fourier  # noqa: E402
from tropical_cyclone_risk_tpu.utils import compile_cache  # noqa: E402

CFG = Namelist(seed_batch=4096)
N = CFG.seed_batch


def _pack():
    return jax.device_get(synthetic_pack(CFG, n_planes=12, nlat=91,
                                         nlon=180, seed=0))


def _dot_precisions(closed):
    """Precision of every dot_general in a closed jaxpr, sub-jaxprs
    (scan, while, cond, pjit bodies) included."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == 'dot_general':
                found.append(eqn.params['precision'])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)
    walk(closed.jaxpr)
    return found


def _all_highest(precisions):
    hi = jax.lax.Precision.HIGHEST
    return all(p is not None and tuple(p) == (hi, hi) for p in precisions)


def test_launch_contractions_are_float32_highest():
    """Every contraction of one traced launch runs at Precision.HIGHEST,
    so no backend may lower it to TF32 or bf16 passes."""
    closed = jax.make_jaxpr(
        lambda k, p: pipeline._simulate_batch(k, p, CFG, 'GL', N, 64,
                                              jnp.int32(0)))(
        jax.random.key(0), _pack())
    precisions = _dot_precisions(closed)
    assert precisions, 'the launch has no contraction to check'
    assert _all_highest(precisions), precisions


@pytest.mark.parametrize('method', ['evaluate_scalar', 'evaluate_grid',
                                    'evaluate_vector'])
def test_fourier_contractions_are_float32_highest(method):
    fs = fourier.draw_fourier(jax.random.key(0), (8, 4), 1.0e6)
    t = jnp.linspace(0.0, 1.0e6, 5)
    fn = {'evaluate_scalar': lambda f: f.evaluate(jnp.float32(3600.0)),
          'evaluate_vector': lambda f: f.evaluate(t),
          'evaluate_grid': lambda f: f.evaluate_grid(t)}[method]
    precisions = _dot_precisions(jax.make_jaxpr(fn)(fs))
    assert precisions and _all_highest(precisions), precisions


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    repo = Path(__file__).resolve().parent.parent
    assert compile_cache.cache_dir() == str(repo / '.jax_cache')
    # the same path in every process: nothing from a pid, tmp name or time
    assert compile_cache.cache_dir() == compile_cache.cache_dir()


def test_compile_cache_enabled_by_conftest():
    assert jax.config.jax_compilation_cache_dir == compile_cache.cache_dir()


def test_device_phase_raises_without_gpu():
    with pytest.raises(RuntimeError, match='no GPU'):
        chip_smoke.phase_device()


@pytest.fixture(scope='module')
def two_cpu_launches():
    cpu = jax.devices('cpu')[0]
    pack = _pack()
    k_max = pipeline.launch_width(CFG, N)
    key = jax.random.key(11)
    return [chip_smoke.launch_on(cpu, key, pack, CFG, N, k_max)
            for _ in range(2)]


def test_compare_measures_identical_runs(two_cpu_launches):
    a, b = two_cpu_launches
    assert chip_smoke.same_bits(a, b)
    m = chip_smoke.compare_measures(a, b)
    assert m['n_kept_both'] > 0
    assert m['jaccard_kept'] == 1.0
    assert m['ks_lmi'] == 0.0
    assert m['proposal_counts_identical']
    assert m['genesis_max_abs_deg'] == 0.0
    assert m['median_max_abs_dv_ms'] == 0.0
    chip_smoke.check_measures(m)


def test_compare_measures_catch_divergence(two_cpu_launches):
    a, b = two_cpu_launches
    b = dict(b, keep=b['keep'].copy(), lat0=b['lat0'] + 1e-3,
             v=b['v'] + 0.5)
    drop = np.flatnonzero(b['keep'])[: max(1, b['keep'].sum() // 10)]
    b['keep'][drop] = False
    m = chip_smoke.compare_measures(a, b)
    assert m['jaccard_kept'] < chip_smoke.LIMITS['jaccard_kept']
    assert m['genesis_max_abs_deg'] > chip_smoke.LIMITS['genesis_max_abs_deg']
    with pytest.raises(AssertionError, match='jaccard_kept'):
        chip_smoke.check_measures(m)


@pytest.mark.gpu
def test_gpu_launch_matches_cpu_reference(gpu_device):
    pack = _pack()
    k_max = pipeline.launch_width(CFG, N)
    key = jax.random.key(11)
    gpu = chip_smoke.launch_on(gpu_device, key, pack, CFG, N, k_max)
    cpu = chip_smoke.launch_on(jax.devices('cpu')[0], key, pack, CFG, N,
                               k_max)
    chip_smoke.check_measures(chip_smoke.compare_measures(gpu, cpu))
