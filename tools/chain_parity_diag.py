"""Offline diagnostics for a chain-parity dump of this framework vs a reference cache.

Three questions about an observed KS excess (tools/chain_parity_report.py):
1. Null calibration — split the JAX side into even/odd launches: same
   machinery, same distribution by construction, so the split KS must sit
   at its own critical's noise floor or the criticals are understated.
2. Deviation shape — where along each statistic's axis the two CDFs
   diverge (argmax of |F1-F2| and the signed gap there).
3. Moment table — mean/median/tails per side, to name the bias in
   physical units.

Usage: python tools/chain_parity_diag.py ours_240k.npz ref_chain_240k.npz
"""
import sys

import numpy as np
from scipy.stats import ks_2samp


def ks_where(a, b):
    """(D, x_at_D, signed gap F_a(x)-F_b(x) at D)."""
    ax = np.sort(a)
    allx = np.sort(np.concatenate([a, b]))
    Fa = np.searchsorted(ax, allx, side='right') / a.size
    Fb = np.searchsorted(np.sort(b), allx, side='right') / b.size
    i = int(np.argmax(np.abs(Fa - Fb)))
    return float(np.abs(Fa - Fb)[i]), float(allx[i]), float((Fa - Fb)[i])


def crit(n1, n2, alpha=1.63):
    return alpha * np.sqrt((n1 + n2) / (n1 * n2))


def main():
    ours = np.load(sys.argv[1])
    ref = np.load(sys.argv[2])
    launch = ours['launch']
    for name in ('lmi', 'lat0', 'pdi'):
        t, r = ours[name], ref[name]
        if name == 'lat0':
            t, r = np.abs(t), np.abs(r)
        ev, od = t[launch % 2 == 0], t[launch % 2 == 1]
        d0 = ks_2samp(ev, od).statistic
        d, x, gap = ks_where(t, r)
        print(f'{name}: KS(ours,ref)={d:.4f} (crit {crit(t.size, r.size):.4f})'
              f' at x={x:.3g} gap={gap:+.4f} | null even/odd KS={d0:.4f} '
              f'(crit {crit(ev.size, od.size):.4f})')
        q = [5, 25, 50, 75, 95]
        print(f'   ours n={t.size} mean={t.mean():.3f} '
              f'pct{q}={np.percentile(t, q).round(3)}')
        print(f'   ref n={r.size} mean={r.mean():.3f} '
              f'pct{q}={np.percentile(r, q).round(3)}')


if __name__ == '__main__':
    main()
