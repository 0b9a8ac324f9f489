"""Slot-stable compaction orders.

The launch idiom "move the masked slots to the front, each class in slot
order" appeared everywhere as ``argsort(where(mask, slot, slot + n))[:w]``
— an O(n log n) sort.  The same permutation is one prefix-sum plus one
scatter (O(n)).  Every production call site (integrate compaction, the
re-compaction boundaries, the seeding retry rounds, survivor compaction)
uses this helper: identical permutation, pinned bit-for-bit, and O(n)
work is the right asymptotic for any wider batch.

Identity: the keys ``where(mask, slot, slot + n)`` are distinct, so the
argsort is unique and equals this rank construction exactly — masked slots
get ranks 0..n_true-1 in slot order, unmasked ones n_true..n-1 in slot
order.  The scatter inverts the rank permutation.  Pinned bit-for-bit by
tests/test_ops_basic.py::test_stable_partition_order.
"""

from __future__ import annotations

import jax.numpy as jnp


def stable_partition_order(mask: jnp.ndarray, w: int | None = None):
    """[n] bool -> int32 order with the True slots first, each class in
    ascending slot order; truncated to the first ``w`` entries.

    Equivalent to ``jnp.argsort(jnp.where(mask, slot, slot + n))[:w]``.
    """
    n = mask.shape[0]
    c = jnp.cumsum(mask.astype(jnp.int32))              # inclusive count
    slot = jnp.arange(n, dtype=jnp.int32)
    rank = jnp.where(mask, c - 1, c[-1] + slot - c)     # a permutation
    order = jnp.zeros((n,), jnp.int32).at[rank].set(slot,
                                                    unique_indices=True)
    return order if w is None or w >= n else order[:w]
