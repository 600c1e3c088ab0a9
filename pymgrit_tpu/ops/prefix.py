"""Parallel-prefix (associative-scan) propagation of affine time steppers.

The reference solves its coarsest grid with a strictly sequential forward
solve (reference src/pymgrit/core/mgrit.py:459-486) and offers AT-MGRIT as
an *approximate* way to break that chain (reference src/pymgrit/core/
at_mgrit.py).  On an accelerator there is an exact alternative for the steppers whose
update is affine and elementwise in the state's own representation,

    u_{k} = A_k * u_{k-1} + c_k        (elementwise per leaf),

which covers Dahlquist (all four integrators) and the spectral-basis heat
models (theta-method in the sine eigenbasis is diagonal): affine maps
compose associatively,

    (A2, c2) o (A1, c1) = (A2*A1, A2*c1 + c2),

so ``jax.lax.associative_scan`` computes ALL n states in O(log n) depth
instead of n sequential scan iterations.  The work grows ~2x (the scan
evaluates ~2n combines) but every combine is an elementwise op over the
whole tube — bandwidth-bound, fully parallel work — while the
sequential chain pays n device-loop latencies.  This is the exact
counterpart of the chain-breaking that AT-MGRIT (truncated
windows) only approximates.

Numerics: the composed products round differently from the sequential
recurrence (different association order), so f32 trajectories agree with
the scan to the usual f32 floor and f64 trajectories to ~1e-12; for stable
steppers (|A| <= 1) the products are non-amplifying.  Not available for
double-double states (the combine would need DD-aware arithmetic; the DD
path keeps the sequential scan).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Pytree = object


def affine_prefix_states(A: Pytree, c: Pytree, x0: Pytree) -> Pytree:
    """All states of ``u_k = A_k * u_{k-1} + c_k`` for k = 1..n, exactly.

    ``A`` and ``c`` are tubes (leading axis n) whose tree structure matches
    the state ``x0``; each ``A`` leaf must broadcast against the matching
    state leaf.  Returns the tube ``[u_1, ..., u_n]`` (``x0`` itself is not
    included).  O(log n) depth via ``lax.associative_scan``.
    """
    tmap = jax.tree_util.tree_map

    def combine(left, right):
        A1, c1 = left
        A2, c2 = right
        return (tmap(jnp.multiply, A2, A1),
                tmap(lambda a2, c1_, c2_: a2 * c1_ + c2_, A2, c1, c2))

    A_cum, c_cum = jax.lax.associative_scan(combine, (A, c))
    # u_k = (A_k ... A_1) * u_0 + (composed inhomogeneity)
    return tmap(lambda ak, ck, x: ak * x[None] + ck, A_cum, c_cum, x0)
