"""Spectral-state + double-double: the accelerator execution modes of Heat2D.

Runs the same 3-level heat_2d problem three ways and checks they walk the
same residual history:

  physical basis, fp64/f32  — the reference-equivalent execution
  basis='spectral'          — state in eigen-coefficient space: elementwise
                              steps, closed-form interval relaxation
  spectral + precision='dd' — float32-pair arithmetic: the reference's
                              1e-10 tolerance class on hardware without
                              fp64 (docs/precision.md)
"""

import numpy as np
import jax.numpy as jnp

from pymgrit_tpu import Heat2D, Mgrit


def build(nt, basis='physical', precision=None):
    return Heat2D(
        x_start=0, x_end=1, y_start=0, y_end=1, nx=33, ny=33, a=1.0,
        rhs=lambda x, y, t: jnp.sin(jnp.pi * x) * jnp.sin(jnp.pi * y)
        * jnp.ones_like(t * x * y),
        init_cond=lambda x, y: np.sin(np.pi * x) * np.sin(np.pi * y),
        t_start=0, t_stop=1, nt=nt, basis=basis, precision=precision)


def main():
    hist = {}
    for tag, basis, prec in (("physical", 'physical', None),
                             ("spectral", 'spectral', None),
                             ("spectral+dd", 'spectral', 'dd')):
        problem = [build(65, basis, prec), build(17, basis, prec),
                   build(5, basis, prec)]
        mgrit = Mgrit(problem=problem, tol=1e-10, max_iter=12)
        hist[tag] = mgrit.solve()['conv']
        print(f"{tag:12s}: {len(hist[tag])} iterations, "
              f"tail {hist[tag][-1]:.3e}")

    base = hist["physical"]
    for tag in ("spectral", "spectral+dd"):
        assert len(hist[tag]) == len(base), (tag, hist[tag], base)
        assert np.allclose(hist[tag][:-1], base[:-1], rtol=1e-4), tag
    print("all three modes walk the same residual history")
    return hist


if __name__ == '__main__':
    main()
