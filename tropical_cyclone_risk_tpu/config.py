"""Configuration for the JAX TC downscaling framework.

This is the typed, immutable equivalent of the reference's ``namelist.py``
(reference: namelist.py:9-119).  Field names and semantics match the reference
one-to-one so existing namelists port directly; the executable config entries
of the reference (the ``f_mInit`` lambda, namelist.py:94) are replaced by the
fixed sigmoid parameters ``m_init_*`` below.

The config is a frozen dataclass of plain Python values: it is *static* with
respect to jit (a new config triggers a recompile, exactly like changing a
model architecture).  Per-basin dictionaries are exposed both as dicts (host
side) and as index-aligned tuples over ``basin_ids_sorted()`` (device side).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Optional, Tuple

# Basin bounds use the reference's string format '<deg><E|W|N|S>'
# (reference: namelist.py:112-119).
DEFAULT_BASIN_BOUNDS: Dict[str, Tuple[str, str, str, str]] = {
    'EP': ('180E', '0N', '290E', '60N'),
    'NA': ('260E', '0N', '360E', '60N'),
    'NI': ('30E', '0N', '100E', '50N'),
    'SI': ('20E', '45S', '100E', '0S'),
    'AU': ('100E', '45S', '180E', '0S'),
    'SP': ('180E', '45S', '250E', '0S'),
    'WP': ('100E', '0N', '180E', '60N'),
    'GL': ('0E', '90S', '360E', '90N'),
}

# Variable-name mapping per dataset type (reference: namelist.py:26-31).
DEFAULT_VAR_KEYS: Dict[str, Dict[str, str]] = {
    'ERA5': {'sst': 'sst', 'mslp': 'sp', 'temp': 't', 'sp_hum': 'q',
             'u': 'u', 'v': 'v', 'w': 'w', 'lvl': 'level',
             'lon': 'longitude', 'lat': 'latitude'},
    'GCM': {'sst': 'tos', 'mslp': 'psl', 'temp': 'ta', 'sp_hum': 'hus',
            'u': 'ua', 'v': 'va', 'w': 'wap', 'lvl': 'plev',
            'lon': 'lon', 'lat': 'lat'},
}


def _freeze(d: Mapping) -> Tuple:
    """Dict -> sorted tuple of items, so the dataclass stays hashable."""
    return tuple(sorted(d.items()))


def _thaw(t: Tuple) -> Dict:
    return dict(t)


@dataclasses.dataclass(frozen=True)
class Namelist:
    # ---- file system (reference: namelist.py:9-17) ----
    base_directory: str = 'data/era5'
    output_directory: str = 'data/era5'
    exp_name: str = 'test'
    dataset_type: str = 'ERA5'            # 'ERA5' or 'GCM'
    exp_prefix: str = 'era5'

    # ---- parallelism (reference: namelist.py:34) ----
    n_procs: int = 16                     # host-side IO parallelism only

    # ---- dates (reference: namelist.py:40-43) ----
    start_year: int = 2016
    start_month: int = 1
    end_year: int = 2021
    end_month: int = 12

    # ---- output (reference: namelist.py:48-50) ----
    output_interval_s: int = 3600
    total_track_time_days: int = 15
    tracks_per_year: int = 20

    # ---- thermodynamics (reference: namelist.py:55-60) ----
    p_midlevel: float = 60000.0           # Pa
    PI_reduc: float = 0.80
    Ck: float = 1.2e-3
    Cd: float = 1.2e-3
    select_thermo: int = 1                # 1 pseudoadiabatic, 2 reversible
    select_interp: int = 2                # 1 optimization, 2 table lookup

    # ---- track / intensity (reference: namelist.py:70-94) ----
    steering_levels: Tuple[int, ...] = (250, 850)
    steering_coefs: Tuple[float, ...] = (0.2, 0.8)
    coupled_track: bool = True
    y_alpha: Tuple[float, ...] = (0.17, 0.83)
    m_alpha: Tuple[float, ...] = (0.0025, -0.0025)
    alpha_max: Tuple[float, ...] = (0.41, 0.78)
    alpha_min: Tuple[float, ...] = (0.22, 0.59)
    u_beta: float = -1.0                  # zonal beta drift, m/s
    v_beta: float = 2.5                   # meridional beta drift, m/s
    T_days: float = 20.0                  # Fourier series period, days
    seed_v_init_ms: float = 5.0
    seed_v_2d_threshold_ms: float = 6.5
    seed_v_threshold_ms: float = 15.0
    seed_vmax_threshold_ms: float = 18.0
    atm_bl_depth: Tuple = _freeze({'NA': 1400.0, 'EP': 1400.0, 'WP': 1800.0,
                                   'AU': 1800.0, 'SI': 1600.0, 'SP': 2000.0,
                                   'NI': 1500.0})
    log_chi_fac: float = 0.5
    chi_fac: float = 1.3
    lat_vort_fac: float = 2.0
    lat_vort_power: Tuple = _freeze({'NA': 6.0, 'EP': 6.0, 'WP': 3.5,
                                     'AU': 6.0, 'SI': 3.0, 'SP': 7.0,
                                     'NI': 2.5})
    # m_init = m_init_amp / (1 + exp(-(rh - m_init_mid) * m_init_slope)) + m_init_base
    # (replaces the reference's f_mInit lambda, namelist.py:94)
    m_init_amp: float = 0.20
    m_init_mid: float = 0.55
    m_init_slope: float = 10.0
    m_init_base: float = 0.125

    # ---- basins (reference: namelist.py:112-119) ----
    basin_bounds: Tuple = _freeze(DEFAULT_BASIN_BOUNDS)
    var_keys_frozen: Tuple = _freeze({k: _freeze(v)
                                      for k, v in DEFAULT_VAR_KEYS.items()})

    # ---- static data files (reference paths: intensity/geo.py:9-34,
    # intensity/ocean.py:11-64, scripts/generate_land_masks.py) ----
    fn_land: str = 'intensity/data/land.nc'
    fn_bathy: str = 'intensity/data/bathymetry.nc'
    fn_mld: str = 'intensity/data/mld_climatology.nc'
    fn_strat: str = 'intensity/data/strat_climatology.nc'
    mask_dir: str = 'land'

    # ---- batched-simulation extensions (no reference equivalent) ----
    seed_batch: int = 8192            # seeds proposed per on-device batch
    # fraction of a seed batch carried through the 361-step integration
    # scan.  Many proposed slots fail the counting / PI gates at step 0
    # (util/compute.py:160-169) yet the scan's field gather — the whole
    # launch cost — is paid per slot per step; compacting the integrable
    # slots to the front (models/pipeline.launch_body) cuts the gather
    # volume by the failing fraction with bit-identical survivor tracks.
    # None (default): the runtime measures the environment's integrable
    # fraction at run start and picks a cap bucket automatically
    # (pipeline.auto_integrate_cap); direct pipeline._simulate_batch calls
    # treat None as uncapped.  If a batch ever has more integrable seeds
    # than the cap, the runtime falls back to an uncapped launch for that
    # batch (models/pipeline.run_tracks_year) — statistics are never
    # clipped.  1.0 disables compaction.
    integrate_cap: Optional[float] = None
    # mid-track re-compaction: at output step recompact_step the launch
    # compacts the still-alive storms (slot-stably) to recompact_cap x the
    # integration width and finishes the scan narrow — storms die along
    # the track (basin exit / |lat|<=2 / v<=4), so the tail of the scan
    # wastes most of its gather rows on frozen corpses.  Trajectories and
    # keep verdicts are exact (frozen-state segments compose exactly); the
    # vmax diagnostic — and, at some strides, the recorded wnds output
    # copy — are pinned to float32 ULP/fusion noise (atol 1e-4 / 2e-5,
    # tests/test_pipeline_stats.py::test_recompaction_identical).
    # None disables; auto-tuned together with integrate_cap from a small
    # pathfinder probe of the alive-decay curve when integrate_cap is None
    # (pipeline.auto_integrate_cap).  Overflow (more survivors at the
    # boundary than the cap) falls back to an unsegmented launch.
    recompact_step: Optional[int] = None
    recompact_cap: Optional[float] = None
    # generalized multi-boundary re-compaction (round 3): ascending
    # (step, cap) pairs, each cap a fraction of the INITIAL integration
    # width m.  The scan re-compacts at every boundary, so the window
    # tracks the measured alive-decay curve instead of one mid-track cut
    # (~25-35% fewer gather rows than the single boundary on the bench
    # environment).  Takes precedence over recompact_step/recompact_cap;
    # boundaries whose 256-rounded width does not shrink are dropped.
    # Same exactness contract and overflow fallback as the single
    # boundary.  Auto-built by pipeline.auto_integrate_cap.
    recompact_schedule: Optional[Tuple[Tuple[int, float], ...]] = None
    # seeding retry-round compaction (round 3): per-retry-round gather
    # widths as fractions of the proposal batch (round 1..R-1 of
    # models/seeding.propose_seeds; round 0 always runs full width).  The
    # unresolved population decays geometrically (ocean-mask pass rate
    # >= 0.5/round), so compacting the still-unresolved slots each round
    # cuts the seeding mask-gather volume from R*n rows to ~(1+sum)*n with
    # BIT-IDENTICAL proposals whenever every unresolved slot fits its
    # round's width.  An unresolved slot beyond a width is dropped (the
    # same uniform thinning as exhausting all rounds; visible in the
    # exported drop counter).  None (default): full width every round for
    # direct calls; the runtime measures the decay curve at run start and
    # fills this in automatically (pipeline.auto_seed_retry_caps, margin
    # 1.25 + 1/128 over the probed curve, 1/64 bucket floor).
    seed_retry_caps: Optional[Tuple[float, ...]] = None
    # speculative quota prefix (round 4): a production year needs only
    # tracks_per_year survivors per batch (the reference's rejection loop
    # STOPS at the quota, util/compute.py:134-210), yet the launch
    # integrates every integrable slot of a 131072-seed batch — ~100x more
    # survivors than a typical quota.  When enabled and the runtime has
    # measured the environment's survivor rate (survivors_per_slot, from
    # the same pathfinder probe that tunes the compaction caps), the year
    # driver integrates only a PREFIX of the integrable slots sized so the
    # quota fills with ~5-sigma headroom (pipeline.quota_cfg), and checks
    # validity on device: survivors found in the leading shard's prefix
    # must cover the remaining quota (the compacted track axis is
    # slot-ordered, so the first quota survivors of the full launch are
    # then provably inside the prefix — bit-identical outputs, pinned by
    # tests/test_pipeline_stats.py::test_quota_prefix_*).  A batch whose
    # prefix cannot settle it relaunches at the tuned full width with the
    # SAME key (identical proposals — nothing is ever clipped).  Direct
    # _simulate_batch calls and the throughput bench are unaffected (they
    # integrate every integrable slot as before).
    quota_prefix: bool = True
    # survivors per INTEGRATED scan slot, measured by the runtime's
    # pathfinder probe (pipeline.auto_integrate_cap, min over the endpoint
    # years, minus 3-sigma binomial probe noise).  None disables the quota
    # prefix (e.g. when compaction caps are set explicitly and the probe
    # never runs).
    survivors_per_slot: Optional[float] = None
    # explicit per-device integration-scan width cap (256-multiple); the
    # MECHANISM the quota prefix rides (pipeline.launch_width takes the
    # min with the integrate_cap width).  Usually set internally by
    # pipeline.quota_cfg; None leaves the cap width untouched.
    integrate_width: Optional[int] = None
    rk_substeps: int = 1              # RK4 substeps per output interval
    # lax.scan unroll factor for the integration scan bodies (XLA replays
    # the body this many times per loop iteration, trading compile time /
    # code size for loop bookkeeping).  Semantics are unchanged at any
    # value (same math per step); op fusion across unrolled iterations can
    # move float32 rounding at ULP level.  The stride-block body already
    # amortizes the loop overhead, so 1 is the default; the effect of
    # unrolling on the H100 is not measured.
    scan_unroll: int = 1
    sim_dtype: str = 'float32'
    # linearly interpolate monthly field planes in track time instead of
    # freezing them at the seed month (the reference freezes:
    # track/bam_track.py:88-91, util/compute.py:107-121).  Genesis anchors
    # at the seed month's mid-month plane; a 15-day track then blends up to
    # halfway into the next month.  Costs one extra gather row per seed per
    # step.  OFF by default for reference parity.
    time_interp_fields: bool = False
    # re-gather environmental fields at every RK stage (exact RK4 in the
    # field dependence) instead of once per output step.  Fields vary on
    # ~100 km scales while a storm moves ~20 km/h, so the default
    # once-per-step sampling (fields AND the Cholesky/Fourier wind
    # coloring) is physically equivalent and far lighter on the
    # gather-bound hot loop; trajectories agree to <0.3 deg over 15 days,
    # well under the stochastic track spread
    # (tests/test_simulator.py::test_frozen_field_step_accuracy).
    rk_exact_stage_fields: bool = False
    # gather environmental fields once per S output steps instead of every
    # step (the next rung of the same ladder as the frozen-per-step mode
    # above): the integration scan runs in S-step blocks, sampling fields
    # at the block-start position and reusing them for all S steps; the
    # Fourier flow F(t), steering weights, ocean feedback, and the FAST
    # ODEs stay per-step exact.  S=3 issues a third of the field gathers
    # of S=1 (its speed on the H100 is not measured).  Field staleness
    # grows to
    # <= S hours / ~S x 0.5 deg of storm motion against ~100 km field
    # scales — consistent with the reference's own adaptive solver, which
    # samples fields only at its RK45 step points (max_step=86400 s,
    # intensity/coupled_fast.py:264-267).  The default 3 is validated by
    # the 105k-seed whole-chain report (docs/chain_parity.json: every KS
    # below its 1% critical) and bounded per-track by
    # tests/test_simulator.py::test_field_sample_stride_accuracy; unlike
    # the compaction knobs it is NOT bit-identical across stride values —
    # set 1 for the tightest per-track solver agreement.  Ignored when
    # rk_exact_stage_fields or rk_substeps > 1.
    field_sample_stride: int = 3
    # compute the vmax diagnostic INSIDE the integration scan (one
    # elementwise sample per step from the live carry positions and winds,
    # simulator._diag_step) instead of the standalone axi_to_max_wind_raw
    # post-pass over the full [T, m] launch buffers.  Same formula, same
    # neighbor values (the post-pass reads back the very positions the
    # scan carries), same last-sample edge extrapolation (applied as an
    # [m]-row fix-up, diagnostics.fix_last_sample) — vmax/peak agree to
    # float32 fusion noise and trajectories are untouched
    # (tests/test_pipeline_stats.py::test_vmax_in_scan_identity).
    # Off by default: the arithmetic sits on the scan's serialized
    # critical path instead of in one bulk [T, m] pass.  Which path wins
    # on the H100 is not measured.
    vmax_in_scan: bool = False
    # fuse batch 0 of this many simulated years into ONE device program
    # (pipeline._simulate_years); <= 1 runs the per-year pipelined loop
    # instead.  Fusion amortizes the per-program dispatch and the host
    # round trip over k years; a small k keeps several groups in flight
    # (groups pipeline 2-deep) even on short runs, while a large k turns a
    # short run into one unpipelined group.  Whether fusion pays on the
    # H100 is not measured (tools/bench_fused_years.py).  Years whose
    # batch 0 cannot settle them (cap overflow, prefix miss, unfilled
    # quota) fall back to the per-year loop with bit-identical results
    # (pipeline.run_tracks_years_fused).
    years_per_program: int = 2
    # freeze storm positions (intensity-only integration) — the reference's
    # Coupled_FAST.debug flag (intensity/coupled_fast.py:32,204-205)
    debug_fixed_position: bool = False
    # seed moisture initialization: 'rh' = the RH sigmoid (the reference
    # pipeline's f_mInit path, util/compute.py:172-174, default) or 'dvdt0'
    # = inversion of dv/dt = 0 with the 5-point vpot max (the reference's
    # gen_track fallback when no m is supplied, coupled_fast.py:152-167)
    m_init_mode: str = 'rh'

    # -------------------- derived helpers --------------------
    @property
    def var_keys(self) -> Dict[str, Dict[str, str]]:
        return {k: _thaw(v) for k, v in self.var_keys_frozen}

    @property
    def basin_bounds_dict(self) -> Dict[str, Tuple[str, str, str, str]]:
        return _thaw(self.basin_bounds)

    @property
    def atm_bl_depth_dict(self) -> Dict[str, float]:
        return _thaw(self.atm_bl_depth)

    @property
    def lat_vort_power_dict(self) -> Dict[str, float]:
        return _thaw(self.lat_vort_power)

    @property
    def n_steering_levels(self) -> int:
        return len(self.steering_levels)

    @property
    def n_wind_levels(self) -> int:
        """Number of wind components (u,v per steering level)."""
        return 2 * len(self.steering_levels)

    @property
    def total_track_time_s(self) -> int:
        return self.total_track_time_days * 24 * 60 * 60

    @property
    def n_steps_output(self) -> int:
        """Number of output samples per track, incl. t=0
        (reference: track/bam_track.py:54-55)."""
        return int(self.total_track_time_s / self.output_interval_s) + 1

    @property
    def T_fourier_s(self) -> float:
        return self.T_days * 24 * 60 * 60

    @property
    def n_months(self) -> int:
        return ((self.end_year - self.start_year) * 12
                + (self.end_month - self.start_month) + 1)

    def basin_ids_sorted(self) -> Tuple[str, ...]:
        """Sorted non-global basin IDs; index order used for all per-basin
        arrays and for ``seeds_per_month`` (reference: util/compute.py:87)."""
        return tuple(sorted(k for k, _ in self.basin_bounds if k != 'GL'))

    def h_bl_by_basin(self) -> Tuple[float, ...]:
        d = self.atm_bl_depth_dict
        return tuple(float(d[b]) for b in self.basin_ids_sorted())

    def lat_vort_power_by_basin(self) -> Tuple[float, ...]:
        d = self.lat_vort_power_dict
        return tuple(float(d[b]) for b in self.basin_ids_sorted())

    def years(self) -> Tuple[int, ...]:
        return tuple(range(self.start_year, self.end_year + 1))

    def replace(self, **kw) -> 'Namelist':
        if 'basin_bounds' in kw and isinstance(kw['basin_bounds'], dict):
            kw['basin_bounds'] = _freeze(kw['basin_bounds'])
        if 'atm_bl_depth' in kw and isinstance(kw['atm_bl_depth'], dict):
            kw['atm_bl_depth'] = _freeze(kw['atm_bl_depth'])
        if 'lat_vort_power' in kw and isinstance(kw['lat_vort_power'], dict):
            kw['lat_vort_power'] = _freeze(kw['lat_vort_power'])
        for key in ('steering_levels', 'steering_coefs', 'y_alpha', 'm_alpha',
                    'alpha_max', 'alpha_min'):
            if key in kw and isinstance(kw[key], list):
                kw[key] = tuple(kw[key])
        return dataclasses.replace(self, **kw)


def load_namelist_py(path: str) -> Namelist:
    """Load a reference-style ``namelist.py`` and map it onto :class:`Namelist`.

    Allows users of the reference to reuse their configuration files verbatim
    (reference: namelist.py is a plain Python module).
    """
    ns: Dict = {}
    with open(path) as f:
        src = f.read()
    exec(compile(src, path, 'exec'), {'os': os, 'np': __import__('numpy'),
                                      'numpy': __import__('numpy'),
                                      '__file__': path}, ns)
    fields = {f.name for f in dataclasses.fields(Namelist)}
    kw = {}
    for k, v in ns.items():
        if k in fields:
            kw[k] = v
    if 'f_mInit' in ns:
        import warnings
        warnings.warn(
            'namelist defines f_mInit (a lambda); this framework uses the '
            'fixed sigmoid m_init_amp/(1+exp(-(rh-m_init_mid)*m_init_slope))'
            '+m_init_base instead — set those fields to match your lambda '
            '(defaults replicate the reference, namelist.py:94)',
            stacklevel=2)
    if 'basin_bounds' in ns:
        kw['basin_bounds'] = _freeze({k: tuple(v)
                                      for k, v in ns['basin_bounds'].items()})
    if 'var_keys' in ns:
        kw['var_keys_frozen'] = _freeze({k: _freeze(v)
                                         for k, v in ns['var_keys'].items()})
    return Namelist().replace(**kw)
