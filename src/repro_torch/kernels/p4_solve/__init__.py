from repro_torch.kernels.p4_solve.ops import (  # noqa: F401
    p4_solve, p4_solve_plain)
