"""The `p4_solve` kernel's wrapper on the CPU: its plain version, its
custom operator and cost, and the checks it makes before any launch.

On the CPU the wrapper runs `p4_solve_plain`, which is the batched torch
solve that `core/solver.py solve_p4` ran before the kernel (its copy,
`_solve_p4_before`, is kept here), so `solve_p4` stays bit for bit what
it was and the parity tests against the reference hold as before
(`tests/test_torch_solver.py`, `test_torch_veds.py`,
`test_torch_streaming.py`, `test_torch_fused.py`). The kernel itself is
held to the plain version on the card (`tests/test_torch_cuda.py`).
"""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.solver import solve_p4
from repro_torch.kernels import KERNEL_COSTS
from repro_torch.kernels.p4_solve import p4_solve, p4_solve_plain
from repro_torch.kernels.p4_solve.ops import (MAX_N, _phi_grad_hess,
                                              _polish_count,
                                              _project_feasible,
                                              barrier_schedule,
                                              seed_grad_norms)
from torch_port_util import p4_candidates, p4_table


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _solve_p4_before(cw, a, q, d, p_max, *, iters=25, mu_final=1e-3,
                     p_init=None, warm_iters=0, far_iters=0,
                     far_grad_tol=0.0):
    """`core/solver.py solve_p4` as it was before the kernel, line for
    line."""
    n = a.shape[-1]
    adaptive = (p_init is not None and warm_iters > 0
                and far_iters > warm_iters and far_grad_tol > 0.0)
    if p_init is None:
        p0 = torch.full_like(a, 0.25) * p_max
        p0[..., 0] = 0.5 * p_max[..., 0]
        n_it = iters
    else:
        p0 = p_init
        n_it = min(int(warm_iters), iters) if warm_iters > 0 else iters
    p = _project_feasible(p0, d, p_max, margin=0.5)
    if adaptive:
        n_run = min(int(far_iters), iters)
        s0 = (1.0 + (a * p).sum(-1))[..., None]
        g0 = torch.linalg.vector_norm(cw[..., None] * a / s0 - q, dim=-1)
        far = g0 > far_grad_tol
        first = torch.where(far, 0, n_run - n_it)[..., None]
        first_pol = torch.where(
            far, 0, _polish_count(n_run, iters)
            - _polish_count(n_it, iters))[..., None]
    else:
        n_run = n_it
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    step_cap = (0.5 * p_max.amax(-1))[..., None]
    mus = barrier_schedule(iters, float(mu_final))[iters - n_run:]
    for i, mu in enumerate(mus):
        grad, hess = _phi_grad_hess(p, a, q, cw, d, p_max, mu)
        hess = hess - 1e-9 * eye
        dlt = torch.linalg.solve_ex(hess, -grad)[0]
        norm = torch.linalg.vector_norm(dlt, dim=-1, keepdim=True)
        dlt = dlt * torch.clamp_max(step_cap / (norm + 1e-12), 1.0)
        p_new = _project_feasible(p + dlt, d, p_max)
        p = torch.where(i >= first, p_new, p) if adaptive else p_new
    lr_cap = (0.05 * p_max.amax(-1))[..., None]
    for j in range(_polish_count(n_run, iters)):
        s = (1.0 + (a * p).sum(-1))[..., None]
        g = cw[..., None] * a / s - q
        lr = lr_cap / (torch.linalg.vector_norm(g, dim=-1, keepdim=True)
                       + 1e-12)
        p_new = _project_feasible(p + lr * g, d, p_max)
        p = torch.where(j >= first_pol, p_new, p) if adaptive else p_new
    val = cw * torch.log1p((a * p).sum(-1)) - (q * p).sum(-1)
    better = val >= 0.0
    p = torch.where(better[..., None], p, 0.0)
    return p, torch.clamp_min(val, 0.0)


CASES = {"cold": {}, "warm": dict(warm_iters=10),
         "adaptive": dict(warm_iters=4, far_iters=25, far_grad_tol=0.05)}


@pytest.mark.parametrize("U", [3, 10])
@pytest.mark.parametrize("case", tuple(CASES))
def test_plain_version_is_solve_p4_before_the_move(case, U):
    """`solve_p4` (through the wrapper, so through `p4_solve_plain` on the
    CPU) gives the bits that the solver gave before the kernel, at the
    service's n = 4 and fig10's n = 11, on inputs laid out as
    `_cot_candidates` lays them out (a broadcast cw, which `solve_p4`
    now makes contiguous). The adaptive case splits its candidates over
    both tiers."""
    cw, a, q, d, pm = p4_candidates(U, seed=U)
    kw = dict(CASES[case])
    if case != "cold":
        kw["p_init"] = p4_table(a.shape, seed=U + 1)
    got = solve_p4(cw, a, q, d, pm, **kw)
    want = _solve_p4_before(cw, a, q, d, pm, **kw)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert bool((got[1] > 0).any()) and bool((got[1] == 0).any())
    if case == "adaptive":
        p = _project_feasible(kw["p_init"], d, pm, margin=0.5)
        far = seed_grad_norms(cw, a, q, p) > kw["far_grad_tol"]
        assert bool(far.any()) and bool((~far).any())


@pytest.mark.parametrize("U", [3, 10])
@pytest.mark.parametrize("case", tuple(CASES))
def test_wrapper_on_the_cpu_is_the_plain_version(case, U):
    """For CPU tensors the wrapper runs its plain version, bit for bit,
    called directly and through its custom operator."""
    cw, a, q, d, pm = p4_candidates(U, seed=2 * U)
    cw = cw.contiguous()
    p_init = None if case == "cold" else p4_table(a.shape, seed=3)
    kw = CASES[case]
    want = p4_solve_plain(cw, a, q, d, pm, p_init, **kw)
    direct = p4_solve(cw, a, q, d, pm, p_init, **kw)
    op = torch.ops.repro.p4_solve(cw, a, q, d, pm, p_init, 25, 1e-3,
                                  kw.get("warm_iters", 0),
                                  kw.get("far_iters", 0),
                                  kw.get("far_grad_tol", 0.0))
    for got in (direct, op):
        for x, y in zip(got, want):
            assert torch.equal(x, y)


@pytest.mark.parametrize("warm", [False, True])
def test_fake_op_shapes_and_dtypes_are_the_plain_versions(warm):
    """On fake tensors the wrapper calls the custom operator, whose fake
    implementation gives the plain version's output shapes and dtypes."""
    cw, a, q, d, pm = (x.contiguous() for x in p4_candidates(10, seed=4))
    p_init = p4_table(a.shape, seed=5) if warm else None
    kw = dict(warm_iters=10) if warm else {}
    real = p4_solve_plain(cw, a, q, d, pm, p_init, **kw)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        args = [mode.from_tensor(x) for x in (cw, a, q, d, pm)]
        fake = p4_solve(*args, None if p_init is None
                        else mode.from_tensor(p_init), **kw)
    for x, y in zip(fake, real):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert x.device == y.device


def test_kernel_cost_counts_operations_and_bytes():
    """`KERNEL_COSTS["repro::p4_solve"]` counts, a candidate of n powers,
    the operations a Newton step needs (the gradient 25 n, the symmetric
    Hessian's distinct entries 7 n (n + 1) / 2 + 3 n, the LU with partial
    pivoting n + 3 n (n - 1) / 2 + (n - 1) n (2 n - 1) / 3, the back
    substitution n^2, the trust region and the projection 13 n + 10),
    15 n + 10 a polish step, 12 n + 12 for the start and the value, 7 n +
    2 for the adaptive budget's seed norm, and the bytes of cw, a, q, d,
    p_max, p_init, p and the value once each; `FlopCounterMode` counts
    the same."""
    cost = KERNEL_COSTS["repro::p4_solve"]
    cw, a, q, d, pm = (x.contiguous() for x in p4_candidates(10, seed=6))
    n_cand, n = 2 * 3 * 10, 11
    newton = 275 + 462 + 33 + (11 + 165 + 770) + 121 + 120
    assert newton == 1957
    polish, ends = 175, 144
    # cold: 25 Newton and 10 polish steps
    assert cost(cw, a, q, d, pm, None, 25, 1e-3, 0, 0, 0.0) == (
        n_cand * (25 * newton + 10 * polish + ends),
        n_cand * 4 * (5 * n + 2))
    # warm at 10 of 25: 10 Newton and 4 polish steps, p_init read
    assert cost(cw, a, q, d, pm, a, 25, 1e-3, 10, 0, 0.0) == (
        n_cand * (10 * newton + 4 * polish + ends),
        n_cand * 4 * (6 * n + 2))
    # adaptive: every candidate counted on the far tier, and its seed norm
    assert cost(cw, a, q, d, pm, a, 25, 1e-3, 4, 25, 0.05)[0] == \
        n_cand * (25 * newton + 10 * polish + ends + 79)
    with FlopCounterMode(display=False) as fc:
        torch.ops.repro.p4_solve(cw, a, q, d, pm, None, 25, 1e-3, 0, 0,
                                 0.0)
    assert fc.get_total_flops() == n_cand * (25 * 1957 + 1894)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """float64, non-contiguous, mixed-device inputs and n above the one
    warp's 32 lanes raise before anything runs, each by name."""
    cw, a, q, d, pm = (x.contiguous() for x in p4_candidates(3, seed=7))
    with pytest.raises(ValueError, match="q must be torch.float32"):
        p4_solve(cw, a, q.double(), d, pm)
    with pytest.raises(ValueError, match="a is not contiguous"):
        p4_solve(cw[..., :2].contiguous(), a[..., :2, :], q[..., :2, :],
                 d[..., :2, :], pm[..., :2, :])
    with pytest.raises(ValueError, match="d must be torch.float32 on cpu"):
        p4_solve(cw, a, q, d.to("meta"), pm)
    with pytest.raises(ValueError, match="p_init has shape"):
        p4_solve(cw, a, q, d, pm, a[..., :2])
    big = torch.zeros((2, MAX_N + 1))
    with pytest.raises(ValueError, match=r"\[1, 32\]"):
        p4_solve(torch.zeros(2), big, big, big, big + 0.3)
