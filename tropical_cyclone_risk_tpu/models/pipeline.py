"""Downscaling pipeline: seeding -> integration -> filtering -> compaction.

Reference equivalent: ``run_tracks`` / ``run_downscaling``
(util/compute.py:64-270).  The reference integrates one seed at a time inside
a rejection loop, one process per year; here each device launch proposes and
integrates a whole batch of seeds, survivors are compacted on device (only
the few surviving tracks are ever pulled to the host), and the host loop
repeats until the per-year track quota fills.

Stopping-rule parity: the reference counts seeds only until the final quota
track survives.  Every batch slot carries a global sequence number, so after
the quota fills the seed counts are truncated at the exact slot of the final
survivor — statistically identical to the reference's interleaved loop.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tropical_cyclone_risk_tpu.config import Namelist
from tropical_cyclone_risk_tpu.models import diagnostics, fast, seeding, simulator
from tropical_cyclone_risk_tpu.models.fields import FieldPack
from tropical_cyclone_risk_tpu.ops import compact as compact_ops
from tropical_cyclone_risk_tpu.ops import fourier
from tropical_cyclone_risk_tpu.utils import basins as _basins_mod


@dataclasses.dataclass
class YearTracks:
    """Survivor tracks of one simulated year (reference run_tracks output,
    util/compute.py:210)."""
    lon: np.ndarray          # [n_tracks, n_steps]
    lat: np.ndarray
    v: np.ndarray
    m: np.ndarray
    vmax: np.ndarray
    wnds: np.ndarray         # [n_tracks, n_steps, W]
    month: np.ndarray        # [n_tracks]
    basin_idx: np.ndarray    # [n_tracks] index into basin_ids_sorted()
    n_seeds: np.ndarray      # [n_basins, 12]
    n_dropped: int = 0       # slots whose every seeding retry round missed
                             # the ocean mask (seeding.N_RETRY_ROUNDS)
    n_proposed: int = 0      # total proposal slots drawn (drop-rate denom)


def _round256(w: float, lo: int, hi: int) -> int:
    """ceil to a multiple of 256, clamped to [lo, hi] — the one width
    bucket rule every scan-width computation shares (launch, boundary
    schedule, legacy recompact)."""
    w = int(-(-int(w) // 256) * 256)
    return min(hi, max(lo, w))


def launch_width(cfg: Namelist, n: int) -> int:
    """Width m of the integration scan for an n-seed proposal batch:
    ceil(n * integrate_cap) rounded up to a multiple of 256.
    integrate_cap=None (auto mode, resolved by the runtime through
    auto_integrate_cap) means uncapped for direct launches.
    integrate_width (the quota prefix's mechanism, quota_cfg) further
    caps the width to an explicit per-device slot count."""
    if cfg.integrate_cap is None or cfg.integrate_cap >= 1.0:
        m = n
    else:
        m = _round256(n * cfg.integrate_cap, 256, n)
    if cfg.integrate_width is not None:
        m = min(m, _round256(cfg.integrate_width, 256, n))
    return m


# auto_integrate_cap chooses among these.  1/64 granularity (round 3; was
# sixteenths): the scan cost is row-proportional, so cap slack is pure
# waste — on the bench environment the finer grid plus denser boundary
# candidates cut scan rows ~15%.  Any tuned (cap, schedule) is its own XLA
# program regardless of grid, so the compile-reuse argument for coarse
# buckets only covered reruns on the same environment — which the
# persistent compile cache already serves; probe noise can flip a 1/64
# bucket between runs (occasional recompile), accepted for the row win.
INTEGRATE_CAP_BUCKETS = tuple(i / 64.0 for i in range(2, 65))

# quota-prefix sizing headroom: the prefix expects E survivors where
# E = quota + QUOTA_Z * sqrt(E) (a z-score on the binomial count), so a
# prefix miss — which costs one full-width relaunch, nothing statistical —
# is a ~1e-6-per-batch event even before the probe's own 3-sigma
# rate-underestimate (auto_integrate_cap) stacks on top
QUOTA_Z = 5.0


def quota_cfg(cfg: Namelist, n_tracks: int, n: int,
              n_dev: int = 1) -> Optional[Namelist]:
    """Speculative quota-prefix launch config, or None when not applicable.

    The production year driver needs only `n_tracks` survivors per batch
    (the reference's rejection loop stops at the quota,
    util/compute.py:134-175), while the tuned launch integrates EVERY
    integrable slot.  Because integrate-compaction is slot-stable, the
    first `n_tracks` survivors of the full launch all live in the first W
    integrable slots for some W; this config integrates only that prefix,
    sized from the probed survivor rate with QUOTA_Z-sigma headroom.
    Validity is checked on device (compact_survivors 'scalars'[4]: the
    provable shard-major survivor count — counts from shards up to and
    including the first prefix-truncated one; the compacted track axis is
    shard-major slot-ordered, so scalars[4] >= needed proves the first
    `needed` survivors sit inside the prefix); a batch that misses
    relaunches at the tuned width with the same key, so outputs are
    bit-identical to never having speculated (trajectories exact; the
    vmax diagnostic to the usual width-dependent float32 fusion noise).

    Mesh note: the per-device width is sized for the
    FULL quota, not quota/n_dev — in the dense case only the leading
    truncated shard's survivors are provably the canonical first ones, so
    a smaller per-device prefix would miss almost every batch, and under
    SPMD lockstep the per-device width IS the wall-clock, so an
    identically-sized prefix on every shard is already wall-clock-optimal
    (non-leading shards' rows are insurance, not critical path).  In
    sparse environments untruncated shards make later shards' survivors
    provable (q_usable above), which is where cross-shard settling
    actually pays.

    The re-compaction schedule is dropped from the prefix launch: its
    caps were tuned as fractions of the full width, and at prefix widths
    the 256-wide rounding makes the segments inert scan/compile overhead.
    n is the GLOBAL proposal batch; n_dev the mesh size (the width is
    per device)."""
    if (not cfg.quota_prefix or cfg.integrate_width is not None
            or not cfg.survivors_per_slot or cfg.survivors_per_slot <= 0.0):
        return None
    sqrt_e = (QUOTA_Z + float(np.sqrt(QUOTA_Z * QUOTA_Z
                                      + 4.0 * n_tracks))) / 2.0
    n_local = max(1, n // max(1, n_dev))
    m_local = launch_width(cfg, n_local)
    w = _round256(sqrt_e * sqrt_e / cfg.survivors_per_slot, 256, n_local)
    if w >= m_local:
        return None                     # the prefix would not shrink the scan
    return cfg.replace(integrate_width=int(w), recompact_schedule=None,
                       recompact_step=None, recompact_cap=None)


def auto_seed_retry_caps(key, pack: FieldPack, cfg: Namelist, basin_id: str,
                         margin: float = 1.25) -> Namelist:
    """Resolve seed_retry_caps=None by probing the retry decay curve.

    One small full-width seeding pass measures how many slots are still
    unresolved after each proposal round (seeding.retry_unresolved_curve;
    the curve is a property of the static run mask x basin bounds, so one
    probe per run suffices).  Each retry round's width is then the probed
    unresolved fraction entering it, with `margin` multiplicative + 1/128
    additive headroom against binomial probe noise, snapped UP to 1/64
    buckets (floor 1/64: at the default 131072-seed batch that is 2048
    slots/round against an expected tail of a handful).  Caps are clamped
    non-increasing; the schedule only engages when it actually removes
    >= 10% of the retry gather rows."""
    if cfg.seed_retry_caps is not None:
        return cfg
    n_p = min(cfg.seed_batch, 8192)
    counts = np.asarray(seeding.retry_unresolved_curve(
        jax.random.fold_in(key, 0x5eed), pack, cfg, basin_id, n_p))
    R = seeding.N_RETRY_ROUNDS
    caps = []
    prev = 1.0
    for r in range(1, R):
        frac = float(counts[r - 1]) / n_p      # unresolved entering round r
        cap = -(-(frac * margin + 1.0 / 128) * 64 // 1) / 64.0   # ceil 1/64
        caps.append(min(prev, max(1.0 / 64, cap)))
        prev = caps[-1]
    if sum(caps) <= 0.9 * (R - 1):
        cfg = cfg.replace(seed_retry_caps=tuple(caps))
    return cfg


def auto_integrate_cap(key, pack: FieldPack, cfg: Namelist, basin_id: str,
                       margin: float = 1.08) -> Namelist:
    """Resolve integrate_cap=None by measuring the environment.

    Runs one seeding pass on the FIRST and LAST simulated years (batch-0
    proposal streams; the same key splits as launch_body), takes the max
    integrable fraction, and picks the smallest cap bucket covering it
    with `margin` headroom.  The fraction is a property of the environment
    (PI coverage x basin geometry) — batch-to-batch spreads are < 1%
    absolute, but it can DRIFT over a multi-decade run (a warming trend
    raises PI coverage), hence the two-endpoint probe; the
    uncapped-fallback in run_tracks_year covers any straggler batch.
    Costs two extra seeding dispatches (~tens of ms) per run."""
    if cfg.integrate_cap is not None:
        return cfg
    from tropical_cyclone_risk_tpu.models import fields as fields_mod
    # retry-compaction widths first, so the integrate-fraction probes below
    # (full seed_batch proposals) already run with compacted retry rounds
    cfg = auto_seed_retry_caps(
        key, fields_mod.slice_pack_year(pack, cfg, 0), cfg, basin_id)
    # probe only years the pack actually holds: a configured year beyond
    # the pack's planes slices to a clamped, vpot-zeroed window
    # (fields.year_plane_indices) whose probe sees zero integrable seeds
    # and zero survivors — it cannot inform the caps and would zero the
    # quota prefix's survivor rate
    n_years = max(1, min(cfg.n_months, pack.n_planes) // 12)
    fracs = []
    for yi in sorted({0, n_years - 1}):
        pack_y = fields_mod.slice_pack_year(pack, cfg, yi)
        k_seed, _ = jax.random.split(jax.random.fold_in(key, yi))
        prop = seeding.propose_seeds(k_seed, pack_y, cfg, basin_id,
                                     cfg.seed_batch,
                                     jnp.int32(cfg.start_month - 1))
        fracs.append(float(np.asarray(
            prop.integrate.mean(dtype=jnp.float32))))
    target = min(1.0, max(fracs) * margin + 1.0 / 64.0)
    cap = next(b for b in INTEGRATE_CAP_BUCKETS if b >= target)
    cfg = cfg.replace(integrate_cap=cap)

    if (cfg.recompact_step is None and cfg.recompact_cap is None
            and cfg.recompact_schedule is None):
        # pathfinder probe: a small full-length launch measuring the
        # alive-decay curve — storms die along the track, so re-compacting
        # the scan at each boundary to the surviving fraction (with
        # headroom) makes the window track the decay curve.  Round 3
        # generalized the single (T1, cap) cut to a multi-boundary
        # schedule: every candidate boundary whose cap bucket shrinks the
        # width joins the schedule (fewer scan rows than the best single
        # cut on the bench environment).
        # Probed at BOTH endpoint years (elementwise max), like the
        # integrate-fraction probe above: bounding monotone climate drift
        # directly lets the margin drop 1.15 -> 1.08, which typically
        # shaves every boundary one 1/64 cap bucket (scan cost is
        # row-proportional; the uncapped fallback + bump_caps re-tune
        # still guard any non-monotone straggler batch).
        n_p = min(cfg.seed_batch, 8192)
        m_p = float(launch_width(cfg, n_p))
        counts = np.zeros((cfg.n_steps_output,), np.int64)
        keep_rates = []
        for yi in sorted({0, n_years - 1}):
            curve_y, keeps_y = _alive_curve_probe(
                jax.random.fold_in(key, 0x9e3779 + yi),
                fields_mod.slice_pack_year(pack, cfg, yi), cfg, basin_id,
                n_p)
            counts = np.maximum(counts, np.asarray(curve_y))
            keeps_y = float(np.asarray(keeps_y))
            # 3-sigma binomial headroom against probe sampling noise: the
            # quota prefix sizes its width from the LOWER rate bound so an
            # optimistic probe cannot make prefix fallbacks routine
            keep_rates.append(
                max(0.0, keeps_y - 3.0 * np.sqrt(keeps_y + 1.0)) / m_p)
        if cfg.quota_prefix and cfg.survivors_per_slot is None \
                and min(keep_rates) > 0.0:
            cfg = cfg.replace(survivors_per_slot=min(keep_rates))
        curve = counts / m_p
        T = cfg.n_steps_output
        steps_2d = int(2 * 24 * 3600 / cfg.output_interval_s)
        # boundary candidates every 30 output steps (snapped to stride
        # multiples by seg_schedule), clamped above the 2-day filter
        # window so the first segment always contains the v_2d sample
        cands = list(range(30, T - 1, 30))
        sched = []
        prev_cap = 1.0
        for T1 in cands:
            if not (steps_2d < T1 < T - 1):
                continue
            frac2 = min(1.0, float(curve[T1]) * 1.08 + 1.0 / 64.0)
            cap2 = next(b for b in INTEGRATE_CAP_BUCKETS if b >= frac2)
            # join only when the cut saves a material share of the scan
            # (>= 0.5% of an uncapped scan's rows): every segment is a
            # separate scan in the XLA program, so near-no-op boundaries
            # cost compile time for nothing
            if cap2 < prev_cap and (prev_cap - cap2) * (T - T1) >= 0.005 * T:
                sched.append((T1, cap2))
                prev_cap = cap2
        if sched:
            edges = [0] + [s for s, _ in sched] + [T]
            caps = [1.0] + [c for _, c in sched]
            rows = sum(c * (edges[i + 1] - edges[i])
                       for i, c in enumerate(caps))
            if rows <= 0.95 * T:               # only split if >=5% saved
                cfg = cfg.replace(recompact_schedule=tuple(sched))
                if not _seg_active(cfg, launch_width(cfg,
                                                     cfg.seed_batch)):
                    # possible when 256-wide rounding leaves every
                    # boundary width equal to the full width at this
                    # batch size — the tuned schedule is inert, which is
                    # harmless but worth surfacing
                    import logging
                    logging.getLogger('tc_risk').info(
                        'tuned recompaction schedule %s is inert at '
                        'seed_batch=%d (width rounding); launches stay '
                        'single-segment', cfg.recompact_schedule,
                        cfg.seed_batch)
    return cfg


@functools.partial(jax.jit, static_argnames=('cfg', 'basin_id', 'n'))
def _alive_curve_probe(key, pack, cfg, basin_id, n):
    """(alive count per output step [T] int32, survivor count [] int32)
    of one small launch — the alive curve tunes the re-compaction
    schedule, the survivor count the quota prefix's survivors_per_slot."""
    body = launch_body(key, pack, cfg, basin_id, n,
                       jnp.int32(cfg.start_month - 1))
    return (body['tm']['alive'].sum(axis=1, dtype=jnp.int32),
            body['trk']['keep'].sum(dtype=jnp.int32))


def recompact_width(cfg: Namelist, m: int) -> int:
    """Width of the post-recompaction scan segment (256-multiple)."""
    if cfg.recompact_cap is None or cfg.recompact_cap >= 1.0:
        return m
    return _round256(m * cfg.recompact_cap, 256, m)


def seg_schedule(cfg: Namelist, m: int) -> tuple:
    """Active re-compaction boundaries as ((step, width), ...) for an
    m-wide launch: ascending steps strictly inside (2-day filter window,
    T-1), strictly decreasing 256-rounded widths (caps are fractions of
    m).  recompact_schedule takes precedence over the single
    recompact_step/recompact_cap pair; inert boundaries (width not
    shrinking after rounding) are dropped."""
    steps_2d = int(2 * 24 * 3600 / cfg.output_interval_s)
    T = cfg.n_steps_output
    if cfg.recompact_schedule is not None:
        pairs = cfg.recompact_schedule
    elif cfg.recompact_step is not None and cfg.recompact_cap is not None:
        pairs = ((int(cfg.recompact_step), float(cfg.recompact_cap)),)
    else:
        return ()
    # strided field sampling gathers at steps k0, k0+S, ...: boundaries
    # snap to multiples of S so every segment's gather steps coincide with
    # the unsegmented launch's (keeps segmented-vs-unsegmented composition
    # exact at any stride; simulator._integrate_blocks)
    stride = 1
    if not cfg.rk_exact_stage_fields and max(1, int(cfg.rk_substeps)) == 1:
        stride = max(1, int(cfg.field_sample_stride))
    out = []
    prev_w = m
    prev_step = 0
    for step, cap in sorted(pairs):
        step = int(round(step / stride)) * stride
        if not (steps_2d < step < T - 1) or cap is None or cap >= 1.0 \
                or step <= prev_step:
            continue
        w = _round256(m * cap, 256, m)
        if w < prev_w:
            out.append((int(step), w))
            prev_w = w
            prev_step = step
    return tuple(out)


def _seg_active(cfg: Namelist, m: int) -> bool:
    """Whether the launch splits into multiple scan segments."""
    return bool(seg_schedule(cfg, m))


def seg_edges_widths(sched, m: int, T: int):
    """(edges [K+1], widths [K]) of the segment decomposition — the one
    place the schedule becomes scan segments (launch_body, bench row
    accounting)."""
    return ([0] + [s for s, _ in sched] + [T],
            [m] + [w for _, w in sched])


def launch_body(key, pack: FieldPack, cfg: Namelist, basin_id: str, n: int,
                plane_offset, shard_index=0):
    """Propose n seeds, integrate, filter — the per-seed work of one launch.
    Shared by the single-device and shard_map paths (parallel.sharding).

    Integrate-compaction: most slots fail the seeding gates at step 0
    (util/compute.py:160-169) but the scan's per-slot-per-step field gather
    is the entire launch cost, so the integrable slots are compacted (in
    slot order) to the front m = launch_width(cfg, n) positions and only
    those enter the scan.  The Fourier flow is still drawn at full batch
    width and gathered, so every slot keeps its exact per-slot RNG stream:
    survivor tracks are bit-identical to an uncapped launch.  'overflow'
    counts integrable seeds beyond the cap (the host falls back to an
    uncapped launch for that batch when it is nonzero).

    Returns {'seed': full-width [n] counting metadata,
             'trk': compacted [m] per-track metadata,
             'tm': time-major [T, m(, W)] track buffers,
             'overflow': [1] int32} — the scan-native layout, so no
    full-batch transpose or NaN-masking pass ever touches the [m, 361]
    buffers (compact_survivors does both on the few survivors instead)."""
    k_seed, k_fourier = jax.random.split(key)
    prop = seeding.propose_seeds(k_seed, pack, cfg, basin_id, n, plane_offset)
    fs = fourier.draw_fourier(k_fourier, (n, cfg.n_wind_levels),
                              cfg.T_fourier_s)
    m = launch_width(cfg, n)
    if m < n:
        # integrable slots first, each class in slot order (stable), so the
        # compacted axis preserves the reference's slot-sequential semantics
        order = compact_ops.stable_partition_order(prop.integrate, m)
        overflow = jnp.maximum(
            prop.integrate.sum(dtype=jnp.int32) - m, 0)[None]
        g = lambda a: jnp.take(a, order, axis=0)
    else:
        order = None
        overflow = jnp.zeros((1,), jnp.int32)
        g = lambda a: a
    params = fast.SeedParams(plane=g(prop.plane), h_bl=g(prop.h_bl),
                             fourier=(fs if order is None else
                                      fourier.take_leading(fs, order)))
    state = fast.State(g(prop.lon), g(prop.lat), g(prop.v_init),
                       g(prop.m_init))
    if cfg.m_init_mode == 'dvdt0':
        state = state._replace(m=fast.init_m_dvdt0(
            pack, cfg, state.lon, state.lat, state.v, params))
    dt_out = float(cfg.output_interval_s)

    sched = seg_schedule(cfg, m)
    if not sched and not cfg.vmax_in_scan:
        raw = simulator.integrate_raw(pack, cfg, basin_id, state, params,
                                      g(prop.integrate))
        is_tc, _ = simulator.tc_filters_raw(cfg, raw)
        vmax, peak = diagnostics.axi_to_max_wind_raw(
            raw.lon, raw.lat, dt_out, raw.v, raw.wnds,
            raw.alive, raw.last_step, cfg)
        keep = is_tc & (peak >= cfg.seed_vmax_threshold_ms)
        tm = {'lon': raw.lon, 'lat': raw.lat, 'v': raw.v, 'm': raw.m,
              'vmax': vmax, 'wnds': raw.wnds, 'alive': raw.alive}
        tms = segs = None
        overflow2 = jnp.zeros((1,), jnp.int32)
    else:
        # ---- multi-segment scan with re-compaction at every boundary ----
        # Generalizes the round-2 two-segment scan: the window shrinks at
        # each schedule boundary to the still-alive storms (slot-stable
        # order), tracking the alive-decay curve.  Frozen-state semantics
        # make segments exactly composable, so survivor trajectories and
        # keep verdicts are bit-identical to an unsegmented launch.
        from tropical_cyclone_risk_tpu.models import fields as fields_mod
        T = cfg.n_steps_output
        edges, widths = seg_edges_widths(sched, m, T)
        bounds = _basins_mod.basin_bounds(cfg, basin_id)
        stacks = fields_mod.build_stacks(pack)
        alive0 = simulator.genesis_alive(pack, cfg, state, params,
                                         g(prop.integrate))

        use_diag = cfg.vmax_in_scan
        raws = []        # per segment: time-major dict on its own axis
        orders = []      # per boundary: gather map axis k-1 -> axis k
        a_idxs = []      # per later segment: composed map seg axis -> A axis
        bnd_states = []  # per segment: carry state AT its end boundary
        boundary_over = []
        state_k, alive_k, params_k = state, alive0, params
        dstate = (simulator.DiagState(jnp.zeros_like(state.lon),
                                      jnp.zeros_like(state.lat),
                                      jnp.full((m,), -jnp.inf))
                  if use_diag else None)
        peak_acc = jnp.full((m,), -jnp.inf) if use_diag else None
        a_idx = None
        prev_w = m
        for k, w in enumerate(widths):
            t0, t1 = edges[k], edges[k + 1]
            if k > 0:
                order_k = compact_ops.stable_partition_order(alive_k, w)
                boundary_over.append(jnp.maximum(
                    alive_k.sum(dtype=jnp.int32) - w, 0))
                gk = lambda a, o=order_k: jnp.take(a, o, axis=0)
                params_k = fast.SeedParams(
                    plane=gk(params_k.plane), h_bl=gk(params_k.h_bl),
                    fourier=fourier.take_leading(params_k.fourier, order_k))
                state_k = fast.State(*(gk(x) for x in state_k))
                alive_k = gk(alive_k)
                if use_diag:
                    dstate = simulator.DiagState(*(gk(x) for x in dstate))
                orders.append(order_k)
                a_idx = order_k if a_idx is None else jnp.take(a_idx,
                                                               order_k)
                a_idxs.append(a_idx)
            outs_k, carry_k = simulator.integrate_segment(
                stacks, cfg, bounds, state_k, alive_k, params_k, t0,
                t1 - t0, diag=dstate,
                t_last=(T - 1 if k + 1 == len(widths) else -1))
            lon_k, lat_k, v_k, m_k, wnds_k, alive_tm = outs_k[:6]
            raw_k = {'lon': lon_k, 'lat': lat_k, 'v': v_k, 'm': m_k,
                     'wnds': wnds_k, 'alive': alive_tm}
            if use_diag:
                raw_k['vmax'] = outs_k[6]
                y_end, alive_end, dstate = carry_k
                # bank this segment's running peak on the ORIGINAL m axis
                # (the boundary gather keeps only still-alive storms, but a
                # storm dropped there must keep its lifetime maximum; max
                # re-banking the gathered continuation rows later is
                # idempotent)
                peak_acc = (jnp.maximum(peak_acc, dstate.peak) if k == 0
                            else peak_acc.at[a_idx].max(dstate.peak))
            else:
                y_end, alive_end = carry_k
            raws.append(raw_k)
            bnd_states.append(y_end)
            state_k, alive_k = y_end, alive_end
            prev_w = w

        # stitched per-slot reductions on the A axis [m]
        last_step = raws[0]['alive'].sum(axis=0, dtype=jnp.int32)
        for ai, r in zip(a_idxs, raws[1:]):
            last_step = last_step + jnp.zeros((m,), jnp.int32).at[ai].add(
                r['alive'].sum(axis=0, dtype=jnp.int32))
        last_step = jnp.maximum(last_step - 1, 0)
        steps_2d = int(2 * 24 * 3600 / cfg.output_interval_s)
        idx_2d = jnp.minimum(last_step, steps_2d)     # < edges[1] always
        v_2d = jnp.take_along_axis(raws[0]['v'], idx_2d[None, :], axis=0)[0]
        thr = cfg.seed_v_threshold_ms
        reach = lambda r: jnp.any(
            jnp.where(r['alive'], r['v'], 0.0) >= thr, axis=0)
        reached = reach(raws[0])
        for ai, r in zip(a_idxs, raws[1:]):
            reached = reached | jnp.zeros((m,), bool).at[ai].set(reach(r))
        is_tc = reached & (v_2d >= cfg.seed_v_2d_threshold_ms) \
            & raws[0]['alive'][0]

        # vmax per segment with exact boundary neighbors; tracks that end
        # in another segment never trigger this segment's end fix-up
        peak = None
        for k, r in enumerate(raws):
            inner = k + 1 < len(raws)
            if k == 0:
                ls_k, pos_before = last_step, None
            else:
                ls_k = jnp.take(last_step, a_idxs[k - 1]) - edges[k]
                prev = raws[k - 1]
                gb = lambda a: jnp.take(a, orders[k - 1], axis=0)
                pos_before = jnp.stack([gb(prev['lon'][-1]),
                                        gb(prev['lat'][-1])])
            if use_diag:
                # in-scan vmax: only each track's FINAL valid sample needs
                # re-deriving (edge extrapolation); its vmax joins the
                # banked running peaks
                vmax_fix, vmax_L, okL = diagnostics.fix_last_sample(
                    r['vmax'], r['lon'], r['lat'], r['v'], r['wnds'],
                    r['alive'], ls_k, dt_out, cfg, pos_before=pos_before)
                r['vmax'] = vmax_fix
                contrib = jnp.where(okL, vmax_L, -jnp.inf)
                peak_acc = (jnp.maximum(peak_acc, contrib) if k == 0
                            else peak_acc.at[a_idxs[k - 1]].max(contrib))
                continue
            # the carry at this segment's end boundary is the sample
            # neighboring its last row (pre-gather, on this segment's axis)
            pos_after = (jnp.stack([bnd_states[k].lon, bnd_states[k].lat])
                         if inner else None)
            vmax_k, peak_k = diagnostics.axi_to_max_wind_raw(
                r['lon'], r['lat'], dt_out, r['v'], r['wnds'], r['alive'],
                ls_k, cfg, pos_before=pos_before, pos_after=pos_after)
            r['vmax'] = vmax_k
            if k == 0:
                peak = peak_k
            else:
                peak = jnp.maximum(peak, jnp.full((m,), -jnp.inf)
                                   .at[a_idxs[k - 1]].set(peak_k))
        if use_diag:
            peak = peak_acc
        keep = is_tc & (peak >= cfg.seed_vmax_threshold_ms)

        # per-segment A-axis maps for survivor column gathers (global
        # across a device mesh via shard_index offsets)
        segs = tuple(
            {'inv': jnp.zeros((m,), jnp.int32).at[ai].set(
                shard_index * w + jnp.arange(w, dtype=jnp.int32)),
             'selected': jnp.zeros((m,), bool).at[ai].set(True)}
            for ai, w in zip(a_idxs, widths[1:]))
        tm = raws[0]
        tms = tuple(raws[1:]) if len(raws) > 1 else None
        if tms is None:
            segs = None
            overflow2 = jnp.zeros((1,), jnp.int32)
        else:
            overflow2 = sum(boundary_over)[None]

    # full-width keep (for the stopping rule's slot-sequential cumsum):
    # scatter the compacted verdicts back to their original slots
    keep_full = (keep if order is None else
                 jnp.zeros((n,), bool).at[order].set(keep))
    body = {
        'seed': {'keep': keep_full, 'counted': prop.counted,
                 'month': prop.month, 'basin_idx': prop.basin_idx,
                 'dropped': prop.dropped},
        'trk': {'keep': keep, 'month': g(prop.month),
                'basin_idx': g(prop.basin_idx)},
        'tm': tm,
        'overflow': jnp.concatenate([overflow, overflow2]),
    }
    if tms is not None:
        body['tms'] = tms
        body['segs'] = segs
    return body


def compact_survivors(body: dict, m: int, k_max: int,
                      constrain=lambda a: a, n_basins: int = 0,
                      n_shards: int = 1):
    """Survivors first in slot order, truncated to k_max; returns the
    (tracks, meta) launch contract ([k_max, T] NaN-masked track buffers).
    m is the integration width (launch_width per device, summed over the
    mesh on the sharded path).  constrain: optional per-array sharding
    constraint applied to the gathered tracks.

    n_basins > 0 additionally precomputes the per-batch host decisions
    INSIDE this (already-dispatched) program, so run_tracks_year reads
    these outputs instead of dispatching _count_seeds_* per batch:
      'scalars'  [5] int32: survivors, integrate-cap overflow, recompact
                 overflow, dropped slots, and the PROVABLY USABLE
                 shard-major survivor count (== survivors when
                 n_shards == 1 and untruncated) — the quota prefix's
                 validity scalar: the compacted track axis is shard-major
                 slot-ordered, so scalars[4] >= needed proves the first
                 `needed` survivors sit inside the integrated prefix
                 (quota_cfg; see the q_usable derivation below);
      'spm_upto' [n_basins, 12]: seeds counted up to the k_max-th
                 survivor's slot (the stopping rule for a batch whose
                 accepted take equals its materialized k_max rows —
                 garbage when fewer than k_max survive, which callers
                 must guard by take == k_max);
      'spm_all'  [n_basins, 12]: seeds counted over the whole batch."""
    seed, trk, tm = body['seed'], body['trk'], body['tm']
    keep = trk['keep']
    order = compact_ops.stable_partition_order(keep, k_max)
    g = lambda a: constrain(jnp.take(a, order, axis=0))
    # time-major gather: pick survivor columns, then transpose / NaN-mask
    # only the [T, k_max] result
    gt = lambda a: constrain(jnp.moveaxis(jnp.take(a, order, axis=1), 0, 1))
    alive_g = gt(tm['alive'])
    if 'tms' in body:
        # stitched multi-segment launch: survivor rows concatenate their
        # segment-0 columns with (for storms that rode each later segment)
        # that segment's column; storms absent from a segment read its
        # column 0 harmlessly — those samples are masked dead below
        gbs = []
        for tm_k, seg_k in zip(body['tms'], body['segs']):
            bcol = g(seg_k['inv'])
            sel = g(seg_k['selected'])
            gb = (lambda a, b=bcol: constrain(
                jnp.moveaxis(jnp.take(a, b, axis=1), 0, 1)))
            alive_g = jnp.concatenate(
                [alive_g, sel[:, None] & gb(tm_k['alive'])], axis=1)
            gbs.append((tm_k, gb))
        col = lambda k: jnp.concatenate(
            [gt(tm[k])] + [gb(tm_k[k]) for tm_k, gb in gbs], axis=1)
    else:
        col = lambda k: gt(tm[k])
    nan = jnp.float32(jnp.nan)
    mask = lambda x: jnp.where(alive_g if x.ndim == alive_g.ndim
                               else alive_g[..., None], x, nan)
    tracks = {
        'lon': mask(col('lon')), 'lat': mask(col('lat')),
        'v': mask(col('v')), 'm': mask(col('m')),
        'vmax': mask(col('vmax')), 'wnds': mask(col('wnds')),
        'month': g(trk['month']), 'basin_idx': g(trk['basin_idx']),
        'valid': g(keep),
    }
    # meta stays full batch width ([n] slot metadata for the stopping rule;
    # only scalars and a [basin, 12] table derived from it are ever fetched)
    meta = {'keep': constrain(seed['keep']),
            'counted': constrain(seed['counted']),
            'basin_idx': constrain(seed['basin_idx']),
            'month': constrain(seed['month']),
            'dropped': constrain(seed['dropped']),
            'overflow': constrain(body['overflow'])}
    if n_basins:
        over = meta['overflow'].reshape(-1, 2).sum(axis=0, dtype=jnp.int32)
        # quota-prefix validity scalar: the PROVABLY usable survivor count
        # in shard-major slot order.  A shard whose integrate prefix
        # truncated integrable slots (per-shard overflow[0] > 0) may hide
        # further survivors that canonically precede every later shard's,
        # so usable = sum of per-shard counts up to and INCLUDING the
        # first truncated shard.  Single shard (or every shard truncated,
        # the dense case): this is exactly the leading shard's count; in
        # sparse environments untruncated shards are exact and later
        # shards' survivors become provable, cutting prefix-miss
        # relaunches.
        keep_sh = meta['keep'].reshape(n_shards, -1)
        q_shard = keep_sh.sum(axis=1, dtype=jnp.int32)
        trunc = meta['overflow'].reshape(n_shards, 2)[:, 0] > 0
        trunc_before = jnp.cumsum(trunc.astype(jnp.int32)) - trunc
        q_usable = jnp.where(trunc_before == 0, q_shard, 0) \
            .sum(dtype=jnp.int32)
        meta['scalars'] = constrain(jnp.stack(
            [meta['keep'].sum(dtype=jnp.int32), over[0], over[1],
             meta['dropped'].sum(dtype=jnp.int32), q_usable]))
        meta['spm_upto'] = constrain(_count_upto_body(
            meta['keep'], meta['counted'], meta['basin_idx'],
            meta['month'], k_max - 1, n_basins))
        meta['spm_all'] = constrain(_count_all_body(
            meta['counted'], meta['basin_idx'], meta['month'], n_basins))
    return tracks, meta


def _strip_tuning(cfg: Namelist) -> Namelist:
    """Drop host-only tuning metadata before a cfg keys a compiled program.

    survivors_per_slot is a probe MEASUREMENT with binomial noise: two
    runs of the same configuration measure slightly different rates, and
    a cfg carrying the raw float would recompile the launch program on
    every production run even though
    the actual program — whose shape depends only on the derived
    integrate_width / cap buckets, all snapped to stable buckets — is
    identical.  Launch tracing never reads the rate (quota_cfg consumes
    it host-side), so every jit/compile-cache boundary strips it here."""
    if cfg.survivors_per_slot is None:
        return cfg
    return cfg.replace(survivors_per_slot=None)


@functools.partial(jax.jit, static_argnames=('cfg', 'basin_id', 'n', 'k_max'))
def _simulate_batch_jit(key, pack: FieldPack, cfg: Namelist, basin_id: str,
                        n: int, k_max: int, plane_offset):
    body = launch_body(key, pack, cfg, basin_id, n, plane_offset)
    return compact_survivors(body, launch_width(cfg, n), k_max,
                             n_basins=len(cfg.basin_ids_sorted()))


def _simulate_batch(key, pack: FieldPack, cfg: Namelist, basin_id: str,
                    n: int, k_max: int, plane_offset):
    """One fused device launch: propose n seeds, integrate, filter, compact.

    Returns per-slot metadata plus the first k_max surviving tracks
    (slot-ordered).  This function is the throughput benchmark unit.
    """
    return _simulate_batch_jit(key, pack, _strip_tuning(cfg), basin_id,
                               n, k_max, plane_offset)


_simulate_batch._cache_size = _simulate_batch_jit._cache_size


@functools.partial(jax.jit,
                   static_argnames=('cfg', 'basin_id', 'n', 'k_max'))
def _simulate_batches_jit(keys, pack: FieldPack, cfg: Namelist,
                          basin_id: str, n: int, k_max: int, plane_offset):
    """K proposal batches fused into ONE device program (lax.scan over the
    per-batch keys [K]): every scan width stays identical to a single
    launch while the per-program dispatch overhead amortizes K-fold.  Returns the (tracks, meta) contract of _simulate_batch with a
    leading [K] batch axis on every leaf; per-batch results are bit-
    identical to K separate _simulate_batch calls (pinned by
    tests/test_pipeline_stats.py::test_fused_batches_identical)."""
    n_basins = len(cfg.basin_ids_sorted())

    def body(_, key):
        b = launch_body(key, pack, cfg, basin_id, n, plane_offset)
        return None, compact_survivors(b, launch_width(cfg, n), k_max,
                                       n_basins=n_basins)

    _, out = jax.lax.scan(body, None, keys)
    return out


def _simulate_batches(keys, pack: FieldPack, cfg: Namelist, basin_id: str,
                      n: int, k_max: int, plane_offset):
    """See _simulate_batches_jit; strips host-only tuning metadata from
    the compile key (_strip_tuning)."""
    return _simulate_batches_jit(keys, pack, _strip_tuning(cfg), basin_id,
                                 n, k_max, plane_offset)


def years_scan(key, years, plane_idx, vpot_valid, pack: FieldPack,
               launch, compact):
    """The shared scan skeleton of the fused multi-year programs (the
    single-device _simulate_years and the SPMD
    parallel.sharding._build_sharded_years): each iteration gathers its
    year's 12 calendar-month planes from the full multi-year pack exactly
    like fields.slice_pack_year (shared index arithmetic:
    fields.year_plane_indices, including the clamped-plane vpot zeroing
    for months outside the data range), derives its batch key as
    fold_in(fold_in(key, year), 0) — run_tracks_year's batch 0 — and runs
    launch(bkey, pack_year) | compact.  Factored so the year-slicing /
    key-derivation logic the bit-identity tests pin exists exactly once."""
    from tropical_cyclone_risk_tpu.models import fields as fields_mod

    def body(_, xs):
        year, idx_k, vm_k = xs
        env = jnp.take(pack.env, idx_k, axis=0)
        env = env.at[..., fields_mod.VPOT].multiply(vm_k[:, None, None])
        p = pack._replace(wind=jnp.take(pack.wind, idx_k, axis=0), env=env)
        bkey = jax.random.fold_in(jax.random.fold_in(key, year), 0)
        return None, compact(launch(bkey, p))

    _, out = jax.lax.scan(body, None, (years, plane_idx, vpot_valid))
    return out


@functools.partial(jax.jit,
                   static_argnames=('cfg', 'basin_id', 'n', 'k_max'))
def _simulate_years_jit(key, years, plane_idx, vpot_valid, pack: FieldPack,
                        cfg: Namelist, basin_id: str, n: int, k_max: int):
    """Batch 0 of K simulated years fused into ONE device program.

    The steady-state production year is one launch (the first seed batch
    fills the whole quota) plus per-year host round trips; scanning K
    year-launches inside one program amortizes the per-program dispatch
    and the host round trip K-fold.  Per-year results are
    bit-identical to run_tracks_year's first batch (pinned by
    tests/test_pipeline_stats.py::test_fused_years_identical); the
    year-slicing scan skeleton is years_scan.

    years [K] int32, plane_idx [K, 12] int32, vpot_valid [K, 12] float32.
    Returns the (tracks, meta) contract of _simulate_batch with a leading
    [K] year axis on every leaf.
    """
    n_basins = len(cfg.basin_ids_sorted())
    plane_off = jnp.int32(cfg.start_month - 1)
    return years_scan(
        key, years, plane_idx, vpot_valid, pack,
        lambda bkey, p: launch_body(bkey, p, cfg, basin_id, n, plane_off),
        lambda b: compact_survivors(b, launch_width(cfg, n), k_max,
                                    n_basins=n_basins))


def _simulate_years(key, years, plane_idx, vpot_valid, pack: FieldPack,
                    cfg: Namelist, basin_id: str, n: int, k_max: int):
    """See _simulate_years_jit; strips host-only tuning metadata from the
    compile key (_strip_tuning)."""
    return _simulate_years_jit(key, years, plane_idx, vpot_valid, pack,
                               _strip_tuning(cfg), basin_id, n, k_max)


def _count_all_body(counted, basin_idx, month, n_basins: int):
    """seeds_per_month [n_basins, 12] of a whole batch, on device (avoids
    fetching the [N] per-slot metadata to the host)."""
    idx = basin_idx * 12 + (month - 1)
    return (jnp.zeros((n_basins * 12,), jnp.int32)
            .at[idx].add(counted.astype(jnp.int32))
            .reshape(n_basins, 12))


def _count_upto_body(keep, counted, basin_idx, month, j, n_basins: int):
    """seeds_per_month over slots up to (and including) the (j+1)-th
    survivor's slot — the reference's stopping rule applied on device."""
    cs = jnp.cumsum(keep.astype(jnp.int32))
    cutoff = jnp.argmax(cs == (j + 1))        # first slot reaching j+1
    in_prefix = jnp.arange(keep.shape[0]) <= cutoff
    return _count_all_body(counted & in_prefix, basin_idx, month, n_basins)


# standalone dispatch wrappers: run_tracks_year's common cases read the
# 'scalars'/'spm_upto'/'spm_all' outputs compact_survivors precomputes
# inside the launch program (no extra dispatch); these remain for the rare
# capped-mid-quota batch whose truncation slot is only known on the host
_count_seeds_all = functools.partial(jax.jit, static_argnames=('n_basins',))(
    _count_all_body)
_count_seeds_upto = functools.partial(jax.jit, static_argnames=('n_basins',))(
    _count_upto_body)


def _dispatch_batch(bkey, pack_y: FieldPack, cfg: Namelist, basin_id: str,
                    N: int, k_max: int, plane_off, mesh):
    """Enqueue one launch (async under jax dispatch) on the year-sliced pack."""
    if mesh is not None:
        from tropical_cyclone_risk_tpu.parallel import sharding
        return sharding.simulate_batch_sharded(
            mesh, bkey, pack_y, cfg, basin_id, N, k_max, plane_off)
    return _simulate_batch(bkey, pack_y, cfg, basin_id, N, k_max, plane_off)


def prefetch_year_batch0(key: jax.Array, pack: FieldPack, cfg: Namelist,
                         basin_id: str, year_idx: int,
                         n_tracks: Optional[int] = None, mesh=None):
    """Dispatch (without blocking) a year's first seed batch; pass the
    result to run_tracks_year(first_batch=...).  The runtime year loop uses
    this to keep one launch in flight across year boundaries, hiding the
    host round-trip and dispatch latency behind device execution (in the
    common case one batch fills the whole year quota, so this pipelines the
    entire run)."""
    n_tracks = n_tracks or cfg.tracks_per_year
    from tropical_cyclone_risk_tpu.models import fields as fields_mod
    pack_y = fields_mod.slice_pack_year(pack, cfg, year_idx)
    # the same speculative-quota derivation run_tracks_year applies to its
    # own dispatches, so a prefetched batch 0 is interpreted consistently
    n_dev = mesh.devices.size if mesh is not None else 1
    cfg_d = quota_cfg(cfg, n_tracks, cfg.seed_batch, n_dev) or cfg
    return _dispatch_batch(jax.random.fold_in(key, 0), pack_y, cfg_d,
                           basin_id, cfg.seed_batch,
                           min(n_tracks, launch_width(cfg_d, cfg.seed_batch)),
                           jnp.int32(cfg.start_month - 1), mesh)


def bump_caps(cfg: Namelist, n_over1: int, n_over2: int, n: int,
              margin: float = 1.08) -> Namelist:
    """Re-tune the compaction caps after an overflow: pick the smallest cap
    bucket covering the overflowed batch's MEASURED demand with the same
    headroom auto_integrate_cap uses.  A drifting environment (e.g. a
    warming trend raising PI coverage beyond the two-endpoint probe's
    bracket) then costs exactly one uncapped fallback launch before
    subsequent batches run compacted again at the wider cap."""
    m = launch_width(cfg, n)
    if n_over1 > 0:
        frac = (m + n_over1) / n
        target = min(1.0, frac * margin + 1.0 / 64.0)
        cap = next(b for b in INTEGRATE_CAP_BUCKETS if b >= target)
        cfg = cfg.replace(integrate_cap=cap)
        m = launch_width(cfg, n)
    if n_over2 > 0 and cfg.recompact_schedule is not None:
        # the overflow total does not say WHICH boundary overflowed, so
        # widen every boundary by the measured total demand (conservative;
        # overflow is a rare drift signal, not a steady state)
        new = []
        for step, cap in cfg.recompact_schedule:
            w = _round256(m * cap, 256, m)
            target2 = min(1.0, (w + n_over2) / m * margin + 1.0 / 64.0)
            cap2 = next(b for b in INTEGRATE_CAP_BUCKETS if b >= target2)
            if cap2 < 1.0:
                new.append((step, cap2))
        # clearing the schedule must DISABLE recompaction, not unmask a
        # stale legacy recompact_step/recompact_cap pair underneath it
        cfg = cfg.replace(recompact_schedule=tuple(new) or None,
                          recompact_step=None, recompact_cap=None) \
            if not new else cfg.replace(recompact_schedule=tuple(new))
    elif n_over2 > 0 and cfg.recompact_cap is not None:
        m2 = recompact_width(cfg, m)
        frac2 = (m2 + n_over2) / m
        target2 = min(1.0, frac2 * margin + 1.0 / 64.0)
        cap2 = next(b for b in INTEGRATE_CAP_BUCKETS if b >= target2)
        if cap2 >= 1.0:
            cfg = cfg.replace(recompact_step=None, recompact_cap=None)
        else:
            cfg = cfg.replace(recompact_cap=cap2)
    return cfg


def run_tracks_year(key: jax.Array, pack: FieldPack, cfg: Namelist,
                    basin_id: str, year_idx: int,
                    n_tracks: Optional[int] = None,
                    max_batches: int = 200, mesh=None,
                    first_batch=None, adapt: Optional[dict] = None
                    ) -> YearTracks:
    """Generate the year's track quota (reference run_tracks,
    util/compute.py:64-210).

    mesh: optional jax.sharding.Mesh — shards each seed batch over the
    device mesh (parallel.sharding) instead of one-device launches.
    first_batch: optional already-dispatched batch 0 (prefetch_year_batch0
    with the same key/config).
    adapt: optional mutable {'cfg': Namelist} shared across years by the
    caller — cap-overflow re-tuning (bump_caps) is written back here so
    later years start from the adapted caps instead of overflowing again."""
    n_tracks = n_tracks or cfg.tracks_per_year
    if adapt is not None:
        cfg = adapt.get('cfg', cfg)
    n_basins = len(cfg.basin_ids_sorted())
    N = cfg.seed_batch
    k_max = min(n_tracks, launch_width(cfg, N))
    n_dev = mesh.devices.size if mesh is not None else 1
    # speculative quota prefix: integrate only a prefix of the integrable
    # slots sized for the year quota (quota_cfg); a batch whose prefix
    # cannot settle it relaunches at the tuned width with the same key
    cfg_q = quota_cfg(cfg, n_tracks, N, n_dev)
    k_max_q = (min(n_tracks, launch_width(cfg_q, N))
               if cfg_q is not None else k_max)

    # one compiled launch shape for every year of every run: slice the pack
    # to this year's 12 calendar-month planes (fields.slice_pack_year) —
    # lazily, because in the steady state the prefetched first batch fills
    # the whole quota and the year-sliced pack is never needed here (the
    # slice would enqueue two device gathers per year for nothing)
    from tropical_cyclone_risk_tpu.models import fields as fields_mod
    pack_y = [None]

    def get_pack_y():
        if pack_y[0] is None:
            pack_y[0] = fields_mod.slice_pack_year(pack, cfg, year_idx)
        return pack_y[0]

    plane_off = jnp.int32(cfg.start_month - 1)

    rows: List[dict] = []
    # seed counting stays on device (the [N] per-slot metadata never
    # crosses to the host), and the per-batch decisions (survivor scalars,
    # whole-batch and stopping-rule-truncated seeds_per_month) are
    # precomputed INSIDE the launch program (compact_survivors
    # n_basins>0): reading outputs of the already-dispatched program needs
    # no extra program execution
    n_seeds = np.zeros((n_basins, 12))
    n_dropped = 0
    n_proposed = 0
    got = 0
    for b_i in range(max_batches):
        q_mode = cfg_q is not None
        if b_i == 0 and first_batch is not None:
            # the prefetch dispatched with the SAME quota derivation
            # (prefetch_year_batch0 applies quota_cfg to the cfg it gets)
            tracks, meta = first_batch
        else:
            tracks, meta = _dispatch_batch(
                jax.random.fold_in(key, b_i), get_pack_y(),
                cfg_q if q_mode else cfg, basin_id,
                N, k_max_q if q_mode else k_max, plane_off, mesh)
        # ONE host fetch for every per-batch decision: the stopping-rule
        # tables ride along with the scalars instead of being fetched
        # separately later (spm_upto/spm_all are n_basins x 12 int32), so
        # each batch costs one device-to-host round trip
        dec = jax.device_get((meta['scalars'], meta['spm_upto'],
                              meta['spm_all']))
        n_new, n_over1, n_over2, n_drop = (int(x) for x in dec[0][:4])
        n_proposed += N
        n_dropped += n_drop
        if q_mode:
            # validity: the provably-usable shard-major survivor count
            # (scalars[4], see compact_survivors) must cover the
            # remaining quota (then the accepted survivors are
            # provably the first ones of the full launch, in slot order)
            # and no recompaction boundary overflowed (none configured by
            # quota_cfg, but an explicit integrate_width could combine).
            # The integrate-cap 'overflow' (n_over1) is EXPECTED here —
            # the prefix truncates integrable slots by design.
            if int(dec[0][4]) >= n_tracks - got and n_over2 == 0:
                n_over1 = n_over2 = 0       # prefix settles this batch
            elif n_over1 == 0 and n_over2 == 0:
                # quota missed but NOTHING was truncated (every integrable
                # slot of every shard fit inside the prefix): the prefix
                # launch already IS the tuned full launch, so its
                # survivors stand and the loop draws the next batch — no
                # relaunch.  This is the collapsed-environment path
                # (tests/test_quota_stress.py): a sparse year costs one
                # launch per batch, not two.
                pass
            else:
                # prefix miss: relaunch at the tuned width with the SAME
                # key (identical proposals — bit-identical to never
                # having speculated), then fall through to the tuned
                # path's own overflow handling.  The relaunch's dropped-
                # slot scalar is discarded (kept: the prefix launch's
                # n_drop, already accumulated): seeding runs at FULL
                # batch width in both launches — integrate_width caps the
                # scan only — so the two dropped scalars are the same
                # value by construction (asserted when debug-checking).
                tracks, meta = _dispatch_batch(
                    jax.random.fold_in(key, b_i), get_pack_y(), cfg,
                    basin_id, N, k_max, plane_off, mesh)
                dec = jax.device_get((meta['scalars'], meta['spm_upto'],
                                      meta['spm_all']))
                n_new, n_over1, n_over2, _relaunch_drop = (
                    int(x) for x in dec[0][:4])
                if __debug__:
                    assert _relaunch_drop == n_drop, (
                        'seeding drops must be integrate-width-independent'
                        f' ({_relaunch_drop} != {n_drop})')
        if n_over1 + n_over2 > 0:
            # more integrable (or boundary-alive) seeds than a compaction
            # cap: redo this batch uncapped (same key -> identical
            # proposals, so nothing is clipped), then RE-TUNE the cap so
            # subsequent batches run compacted again instead of repeating
            # the fallback (a drifting environment overflows persistently)
            import logging
            logging.getLogger('tc_risk').warning(
                'compaction cap overflowed by %d/%d seeds (batch %d, '
                'integrate_cap=%s recompact %s); falling back to an '
                'uncapped launch', n_over1, n_over2, b_i, cfg.integrate_cap,
                cfg.recompact_schedule
                if cfg.recompact_schedule is not None
                else (cfg.recompact_step, cfg.recompact_cap))
            cfg_full = cfg.replace(integrate_cap=1.0, recompact_step=None,
                                   recompact_cap=None,
                                   recompact_schedule=None)
            tracks, meta = _dispatch_batch(
                jax.random.fold_in(key, b_i), get_pack_y(), cfg_full,
                basin_id, N, min(n_tracks, N), plane_off, mesh)
            dec = jax.device_get((meta['scalars'], meta['spm_upto'],
                                  meta['spm_all']))
            n_new = int(dec[0][0])
            cfg = bump_caps(cfg, n_over1, n_over2, N)
            k_max = min(n_tracks, launch_width(cfg, N))
            cfg_q = quota_cfg(cfg, n_tracks, N, n_dev)
            k_max_q = (min(n_tracks, launch_width(cfg_q, N))
                       if cfg_q is not None else k_max)
            if adapt is not None:
                adapt['cfg'] = cfg
            logging.getLogger('tc_risk').warning(
                'caps re-tuned: integrate_cap=%s recompact %s',
                cfg.integrate_cap,
                cfg.recompact_schedule
                if cfg.recompact_schedule is not None
                else (cfg.recompact_step, cfg.recompact_cap))
        # cap at k_max: a sharded launch can keep more survivors than the
        # k_max materialized track rows (per-shard width rounding); the
        # extras are simply not accepted this batch and the loop draws
        # another batch for the remaining quota
        # clamp by the batch's actually-materialized rows too: a prefetched
        # first_batch dispatched before an adaptive cap bump can carry a
        # smaller k_max than the re-tuned cfg implies — slicing past its
        # rows would silently under-append while `got` overcounts
        bk_max = int(tracks['lon'].shape[0])    # this batch's materialized
        take = min(n_new, n_tracks - got, k_max, bk_max)

        def spm_upto(j):
            # precomputed inside the launch for j == bk_max - 1 (the
            # common full-quota batch); other truncation slots need a
            # dispatch (rare: quota partially filled then capped)
            if j == bk_max - 1:
                return np.asarray(dec[1])
            return np.asarray(_count_seeds_upto(
                meta['keep'], meta['counted'], meta['basin_idx'],
                meta['month'], jnp.int32(j), n_basins))

        if take > 0:
            host = jax.device_get({k: v[:take] for k, v in tracks.items()})
            rows.append(host)
            got += take
        if got >= n_tracks:
            n_seeds += spm_upto(take - 1)
            break
        if 0 < take < n_new:
            # capped by k_max with quota still open: the discarded
            # survivors are re-drawn from the next batch, so seeds after
            # the last ACCEPTED survivor's slot must not count either
            # (they are statistically replaced by the next batch's stream)
            n_seeds += spm_upto(take - 1)
        else:
            n_seeds += np.asarray(dec[2])
    else:
        raise RuntimeError(
            f'track quota not reached after {max_batches} batches '
            f'({got}/{n_tracks}); environment may not support genesis')

    cat = lambda k: np.concatenate([r[k] for r in rows], axis=0)[:n_tracks]
    return YearTracks(lon=cat('lon'), lat=cat('lat'), v=cat('v'), m=cat('m'),
                      vmax=cat('vmax'), wnds=cat('wnds'), month=cat('month'),
                      basin_idx=cat('basin_idx'), n_seeds=n_seeds,
                      n_dropped=n_dropped, n_proposed=n_proposed)


def run_tracks_years_fused(key: jax.Array, pack: FieldPack, cfg: Namelist,
                           basin_id: str, years: List[int],
                           n_tracks: Optional[int] = None,
                           adapt: Optional[dict] = None,
                           k_fuse: Optional[int] = None,
                           mesh=None) -> List[YearTracks]:
    """Multi-year driver: batch 0 of k_fuse years runs as ONE device
    program (_simulate_years), amortizing the per-program dispatch and
    host round trip across years; two programs are kept in flight so the
    host round trip overlaps device execution.

    A year settles on the fused path when its batch 0 fills the whole
    quota with no compaction-cap overflow — the steady state (survivors
    per 131072-seed batch are ~100x a typical quota).  Any other year
    (cap overflow, quota unfilled, launch_width < quota) falls back to
    run_tracks_year with the identical per-year key, reproducing batch 0
    bit-exactly and continuing from batch 1, so results match the
    per-year loop in every case.  `years` are calendar years (cfg.years()
    order); year_idx for field slicing is the position.  `adapt` carries
    cap re-tuning across fallbacks exactly as in run_tracks_year.
    `mesh`: optional seed-axis device mesh — the fused program runs SPMD
    (parallel.sharding.simulate_years_sharded), matching the sharded
    per-year loop's results instead of the single-device one's (sharded
    launches fold the device index into the per-shard RNG key)."""
    import logging
    import time as time_mod
    from tropical_cyclone_risk_tpu.models import fields as fields_mod
    log = logging.getLogger('tc_risk')
    n_tracks = n_tracks or cfg.tracks_per_year
    if k_fuse is None:
        k_fuse = max(1, cfg.years_per_program)
    N = cfg.seed_batch
    cfg0 = adapt.get('cfg', cfg) if adapt is not None else cfg
    if min(n_tracks, launch_width(cfg0, N)) < n_tracks:
        # the steady-state condition is unreachable (a batch materializes
        # fewer track rows than the quota, so EVERY year needs the
        # multi-batch loop): don't pay for fused programs whose results
        # would all be discarded — run the per-year loop directly, with
        # the same one-launch-in-flight pipelining the runtime's unfused
        # branch uses
        results = []
        pending = prefetch_year_batch0(
            jax.random.fold_in(key, years[0]), pack, cfg0, basin_id, 0,
            n_tracks=n_tracks, mesh=mesh) if years else None
        for yi, year in enumerate(years):
            nxt = prefetch_year_batch0(
                jax.random.fold_in(key, years[yi + 1]), pack,
                adapt.get('cfg', cfg0) if adapt is not None else cfg0,
                basin_id, yi + 1, n_tracks=n_tracks, mesh=mesh) \
                if yi + 1 < len(years) else None
            results.append(run_tracks_year(
                jax.random.fold_in(key, year), pack, cfg, basin_id, yi,
                n_tracks=n_tracks, mesh=mesh, first_batch=pending,
                adapt=adapt))
            pending = nxt
        return results
    groups = [list(range(i, min(i + k_fuse, len(years))))
              for i in range(0, len(years), k_fuse)]
    t0 = time_mod.time()

    n_dev = mesh.devices.size if mesh is not None else 1

    def dispatch(g):
        cfg_g = adapt.get('cfg', cfg) if adapt is not None else cfg
        # speculative quota prefix, same derivation as run_tracks_year —
        # a fallback year reuses this launch as its batch 0, so both
        # sides must agree on the launch's interpretation
        cfg_q = quota_cfg(cfg_g, n_tracks, N, n_dev)
        cfg_d = cfg_q if cfg_q is not None else cfg_g
        k_max = min(n_tracks, launch_width(cfg_d, N))
        # pad a short TAIL group to the full k_fuse shape (duplicating the
        # last year; extraction below reads only the real entries): one
        # program shape for every group of the run — a second shape would
        # cost a full compile to save a fraction of one launch.  A run shorter than one group keeps its natural
        # shape (nothing to share, padding would only waste launches).
        gp = g + [g[-1]] * (k_fuse - len(g)) if len(groups) > 1 else g
        iv = [fields_mod.year_plane_indices(cfg_g, pack.n_planes, yi)
              for yi in gp]
        yrs = jnp.asarray(np.array([years[yi] for yi in gp], np.int32))
        idx = jnp.asarray(np.stack([x[0] for x in iv]))
        vld = jnp.asarray(np.stack([x[1] for x in iv]))
        if mesh is not None:
            from tropical_cyclone_risk_tpu.parallel import sharding
            out = sharding.simulate_years_sharded(
                mesh, key, yrs, idx, vld, pack, cfg_d, basin_id, N, k_max)
        else:
            out = _simulate_years(key, yrs, idx, vld, pack, cfg_d,
                                  basin_id, N, k_max)
        return out, cfg_g, k_max, cfg_q is not None

    results: List[Optional[YearTracks]] = [None] * len(years)
    pending = dispatch(groups[0]) if groups else None
    for gi, g in enumerate(groups):
        (tracks, meta), cfg_g, k_max, q_mode = pending
        pending = dispatch(groups[gi + 1]) if gi + 1 < len(groups) else None
        # one host fetch per group: every per-year decision plus the track
        # rows in a single round trip
        host_tracks, scalars, spm_upto = jax.device_get(
            ({k: tracks[k] for k in ('lon', 'lat', 'v', 'm', 'vmax',
                                     'wnds', 'month', 'basin_idx')},
             meta['scalars'], meta['spm_upto']))
        for j, yi in enumerate(g):
            n_new, n_over1, n_over2, n_drop = (int(x)
                                               for x in scalars[j][:4])
            if q_mode:
                # quota-prefix launch: the integrate-cap overflow is the
                # prefix truncation itself (expected); a year settles when
                # the leading shard's prefix survivors cover the quota
                settled = (n_over2 == 0
                           and int(scalars[j][4]) >= n_tracks
                           and k_max >= n_tracks)
            else:
                settled = (n_over1 + n_over2 == 0 and n_new >= n_tracks
                           and k_max >= n_tracks)
            if settled:
                # steady state: quota filled by batch 0, caps held.  The
                # stopping-rule seed counts for take == k_max were
                # precomputed inside the launch (compact_survivors).
                results[yi] = YearTracks(
                    lon=host_tracks['lon'][j][:n_tracks],
                    lat=host_tracks['lat'][j][:n_tracks],
                    v=host_tracks['v'][j][:n_tracks],
                    m=host_tracks['m'][j][:n_tracks],
                    vmax=host_tracks['vmax'][j][:n_tracks],
                    wnds=host_tracks['wnds'][j][:n_tracks],
                    month=host_tracks['month'][j][:n_tracks],
                    basin_idx=host_tracks['basin_idx'][j][:n_tracks],
                    n_seeds=np.asarray(spm_upto[j], np.float64),
                    n_dropped=n_drop, n_proposed=N)
            else:
                # rare: overflow or unfilled quota — finish the year on
                # the general path, REUSING this launch as its batch 0
                # (it IS run_tracks_year's batch 0: same key, same caps)
                # so the loop continues from batch 1 / replays uncapped /
                # re-tunes caps without re-running the launch
                fb = jax.tree_util.tree_map(lambda x: x[j], (tracks, meta))
                results[yi] = run_tracks_year(
                    jax.random.fold_in(key, years[yi]), pack, cfg_g,
                    basin_id, yi, n_tracks=n_tracks, adapt=adapt,
                    mesh=mesh, first_batch=fb)
        done = sum(r is not None for r in results)
        log.info('years %d-%d: %d tracks, %.1f s elapsed (%d/%d years)',
                 years[g[0]], years[g[-1]],
                 sum(results[yi].lon.shape[0] for yi in g),
                 time_mod.time() - t0, done, len(years))
    return results


def concat_years(years: List[YearTracks], cfg: Namelist):
    """Assemble the multi-year output arrays (reference run_downscaling
    concatenation, util/compute.py:233-247)."""
    out = {
        'lon': np.concatenate([y.lon for y in years]),
        'lat': np.concatenate([y.lat for y in years]),
        'v': np.concatenate([y.v for y in years]),
        'm': np.concatenate([y.m for y in years]),
        'vmax': np.concatenate([y.vmax for y in years]),
        'wnds': np.concatenate([y.wnds for y in years]),
        'month': np.concatenate([y.month for y in years]),
        'basin_idx': np.concatenate([y.basin_idx for y in years]),
        'n_seeds': np.stack([y.n_seeds for y in years]),
        'year': np.concatenate([
            np.full(y.lon.shape[0], cfg.start_year + i)
            for i, y in enumerate(years)]),
    }
    return out
