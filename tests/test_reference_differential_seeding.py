"""Differential test of the genesis seeding distribution against the ACTUAL
reference seed-rejection loop (util/compute.py:134-175), executed in-process.

The seeding block is the model's frequency signal (seeds_per_month) and was
previously covered by a builder-re-derived sequential oracle
(tests/test_seeding_parity.py) plus the whole-chain report.  This module
removes the re-derivation from the loop: the reference's own source lines —
the area-weighted first draw, the uniform-over-basin-bounds ocean retries,
month draw, basin argmax, equatorward rejection, PI gate, and the
v_init/m_init initialization — are extracted verbatim from
/root/reference/util/compute.py (the module itself imports xarray, absent
here, so the block is exec'd rather than imported) and driven over synthetic
spline fields mirroring a FieldPack; the resulting seed population is
compared distributionally against models/seeding.propose_seeds on the same
fields.

Both sides share the real reference namelist, the reference's own
TC_Basin('GL').get_bounds(), and the reference's interp2_fx spline factory,
so any disagreement in the sampling algebra or gate semantics would surface
as a distribution shift.
"""

from __future__ import annotations

import os
import sys
import textwrap
import types

import numpy as np
import pytest
from scipy.stats import chi2_contingency, ks_2samp

import jax

from tropical_cyclone_risk_tpu.config import load_namelist_py
from tropical_cyclone_risk_tpu.models import fields as F
from tropical_cyclone_risk_tpu.models import seeding
from tropical_cyclone_risk_tpu.models.fields import synthetic_pack

REF = '/root/reference'

pytestmark = pytest.mark.filterwarnings(
    'ignore:namelist defines f_mInit')

N_REF_PASSES = 2500          # integrable seeds collected from the ref loop
N_OURS = 65536               # proposal slots on our side
P_MIN = 1e-3                 # two-sided test floor (deterministic seeds)


def _extract_seed_block():
    """The reference seed-rejection block as dedented source: from
    'seed_passed = False' through the m_init line (compute.py:135-175)."""
    lines = open(REF + '/util/compute.py').read().splitlines()
    start = next(i for i, l in enumerate(lines)
                 if l.strip() == 'seed_passed = False')
    end = next(i for i, l in enumerate(lines)
               if 'm_init = np.maximum' in l)
    block = textwrap.dedent('\n'.join(lines[start:end + 1]))
    assert 'np.arcsin' in block and 'prob_lowlat' in block
    return compile(block, 'compute.py::seed-rejection-loop', 'exec')


class _CountingVpot:
    """f_vpot stand-in that counts .ev calls: pi_gen is evaluated exactly
    once per proposal iteration (compute.py:162), so the shared counter
    yields the reference loop's proposal count."""

    def __init__(self, spl, counter):
        self._spl = spl
        self._counter = counter

    def ev(self, x, y):
        self._counter[0] += 1
        return self._spl.ev(x, y)


@pytest.fixture(scope='module')
def populations():
    if not os.path.isdir(REF):
        pytest.skip(f'reference source tree {REF} is not present')
    sys.path.insert(0, REF)
    try:
        import namelist as ref_namelist
        from util import basins as ref_basins
        from util import mat as ref_mat
    finally:
        sys.path.remove(REF)

    cfg = load_namelist_py(REF + '/namelist.py')
    pack = synthetic_pack(cfg, n_planes=12, nlat=91, nlon=180, seed=7)

    g = pack.grid
    lon = np.asarray(g.lon0 + g.dlon * np.arange(g.nlon))
    lat = np.asarray(g.lat0 + g.dlat * np.arange(g.nlat))
    basin_ids = np.array(cfg.basin_ids_sorted())
    # the reference sorts the non-GL basin ids the same way
    assert list(basin_ids) == sorted(k for k in ref_namelist.basin_bounds
                                     if k != 'GL')

    spl = lambda a: ref_mat.interp2_fx(lon, lat, np.asarray(a))
    f_b = spl(pack.run_mask)
    f_basins = {b: spl(pack.basin_masks[..., i])
                for i, b in enumerate(basin_ids)}
    n_prop_counter = [0]
    cpl_fast = []
    m_init_fx = []
    for p in range(12):
        cpl_fast.append(types.SimpleNamespace(f_vpot=_CountingVpot(
            spl(pack.env[p, ..., F.VPOT]), n_prop_counter)))
        m_init_fx.append(spl(pack.env[p, ..., F.RH]))

    b_bounds = ref_basins.TC_Basin('GL').get_bounds()
    # identical proposal box on both sides (0-360 native for GL)
    from tropical_cyclone_risk_tpu.utils import basins as my_basins
    np.testing.assert_allclose(my_basins.basin_bounds(cfg, 'GL'),
                               np.asarray(b_bounds, float))

    code = _extract_seed_block()
    n_seeds = np.zeros((len(basin_ids), 12))
    env_g = {'np': np, 'namelist': ref_namelist}
    env_l = {'b_bounds': b_bounds, 'f_b': f_b, 'f_basins': f_basins,
             'basin_ids': basin_ids, 'cpl_fast': cpl_fast,
             'm_init_fx': m_init_fx, 'n_seeds': n_seeds}
    np.random.seed(20260817)
    ref = {'lon': [], 'lat': [], 'month': [], 'basin': [], 'v': [], 'm': []}
    for _ in range(N_REF_PASSES):
        exec(code, env_g, env_l)
        ref['lon'].append(env_l['gen_lon'])
        ref['lat'].append(env_l['gen_lat'])
        ref['month'].append(env_l['month_seed'])
        ref['basin'].append(env_l['basin_idx'])
        ref['v'].append(env_l['v_init'])
        ref['m'].append(env_l['m_init'])
    ref = {k: np.asarray(v) for k, v in ref.items()}
    ref['spm'] = n_seeds.copy()
    ref['n_proposals'] = n_prop_counter[0]
    ref['n_counted'] = int(n_seeds.sum())

    prop = seeding.propose_seeds(jax.random.key(3), pack, cfg, 'GL',
                                 N_OURS, int(cfg.start_month - 1))
    mine = {k: np.asarray(getattr(prop, k))
            for k in ('lon', 'lat', 'month', 'basin_idx', 'counted',
                      'integrate', 'v_init', 'm_init', 'dropped')}
    mine['spm'] = seeding.count_seeds_per_month(
        mine['basin_idx'], mine['month'], mine['counted'], len(basin_ids))
    return ref, mine


def test_gate_rates_differential(populations):
    """Counted-per-proposal and integrable-per-proposal rates agree within
    binomial noise (the reference's inner ocean-retry loop never gives up,
    so our dropped slots are removed from the denominator — uniform
    thinning, models/seeding.N_RETRY_ROUNDS)."""
    ref, mine = populations
    n_prop = int((~mine['dropped']).sum())
    for key, ref_k in (('counted', ref['n_counted']),
                       ('integrate', N_REF_PASSES)):
        p_mine = mine[key].sum() / n_prop
        p_ref = ref_k / ref['n_proposals']
        se = np.sqrt(p_ref * (1 - p_ref) * (1 / ref['n_proposals']
                                            + 1 / n_prop))
        assert abs(p_mine - p_ref) < 4.5 * se, (key, p_mine, p_ref)


def test_integrable_position_distributions(populations):
    """Genesis lon / lat / |lat| of gate-passing seeds."""
    ref, mine = populations
    sel = mine['integrate']
    assert sel.sum() > 5000
    for a, b in ((ref['lon'], mine['lon'][sel]),
                 (ref['lat'], mine['lat'][sel]),
                 (np.abs(ref['lat']), np.abs(mine['lat'][sel]))):
        assert ks_2samp(a, b).pvalue > P_MIN


def test_integrable_month_basin_distributions(populations):
    ref, mine = populations
    sel = mine['integrate']
    t_month = np.stack([np.bincount(ref['month'] - 1, minlength=12),
                        np.bincount(mine['month'][sel] - 1, minlength=12)])
    assert chi2_contingency(t_month).pvalue > P_MIN
    nb = ref['spm'].shape[0]
    t_basin = np.stack([np.bincount(ref['basin'], minlength=nb),
                        np.bincount(mine['basin_idx'][sel], minlength=nb)])
    # drop empty-on-both-sides basins (chi2 needs positive marginals)
    t_basin = t_basin[:, t_basin.sum(axis=0) > 0]
    assert chi2_contingency(t_basin).pvalue > P_MIN


def test_seeds_per_month_table_differential(populations):
    """The (basin, month) counted-seed table — the frequency signal — as a
    two-way contingency test between the chains."""
    ref, mine = populations
    a = ref['spm'].ravel()
    b = mine['spm'].ravel()
    keep = (a + b) > 0
    assert chi2_contingency(np.stack([a[keep], b[keep]])).pvalue > P_MIN


def test_initial_state_distributions(populations):
    """v_init (Gaussian around seed_v_init_ms) and m_init (RH sigmoid
    through the reference's f_mInit lambda vs our fitted parameters) of
    gate-passing seeds."""
    ref, mine = populations
    sel = mine['integrate']
    assert ks_2samp(ref['v'], mine['v_init'][sel]).pvalue > P_MIN
    assert ks_2samp(ref['m'], mine['m_init'][sel]).pvalue > P_MIN
    assert 0.0 <= ref['m'].min() and ref['m'].max() <= 1.0
