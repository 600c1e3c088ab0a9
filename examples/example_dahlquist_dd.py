"""README Dahlquist config in double-double precision (docs/precision.md).

The reference's headline run (reference README.rst:88-109) needs fp64:
5 MGRIT iterations to 3.975e-12 at tol=1e-10.  This example reproduces that
history from float32 pairs (ops/dd.py), without fp64 arithmetic.
"""

import numpy as np

from pymgrit_tpu import Mgrit, simple_setup_problem
from pymgrit_tpu.models.dahlquist import Dahlquist


def main():
    dahlquist = Dahlquist(t_start=0, t_stop=5, nt=101, precision='dd')
    problem = simple_setup_problem(problem=dahlquist, level=2, coarsening=2)
    mgrit = Mgrit(problem=problem, tol=1e-10)
    info = mgrit.solve()

    golden = np.array([7.186e-5, 1.246e-6, 2.102e-8, 3.144e-10, 3.975e-12])
    conv = np.asarray(info['conv'])
    assert len(conv) == 5, f"expected the reference's 5 iterations, got {conv}"
    assert np.allclose(conv, golden, rtol=2e-3), (conv, golden)
    print("DD history matches the reference fp64 golden:", conv)
    return info


if __name__ == '__main__':
    main()
