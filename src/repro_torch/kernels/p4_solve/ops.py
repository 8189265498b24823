"""P4's interior-point solve for every cooperative candidate: CUDA kernel
wrapper and its plain PyTorch version.

The kernel (`csrc/p4_solve.cu`) replaces no Pallas kernel: the reference
solves P4 inside its compiled slot scan as one vmapped function
(`repro/core/solver.py solve_p4`). `p4_solve` takes candidate grids of
any leading shape ([..., n] powers, n = 1 + U <= 32, and [...] weights)
and solves each candidate in one warp of one launch. For tensors on the
CPU it runs `p4_solve_plain`; for CUDA tensors it launches the kernel, or
raises. No work is shared across candidates, so on the card a candidate
gets the same bits whatever else is in the batch.

The launch is safe to capture into a CUDA graph (`core/veds.py` replays
the VEDS slot step as one): it goes on PyTorch's current stream, passes
the barrier schedule by value in the launch's arguments, allocates only
through `torch.empty` and does not synchronise (but once a process and
device, outside any capture, when it makes the device's counters).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import (DeviceCounts, check_device, register_cost,
                                 through_operator)
from repro_torch.kernels.build import load_library

# the kernel's limits: one warp a candidate, lane i owning row i of the
# Newton system; the schedule's weights in a fixed-size argument
MAX_N = 32
MAX_STEPS = 64
# the launch's geometry (`p4_geometry`): warps (candidates) a block, and
# the most blocks a grid takes
WARPS_PER_BLOCK = 4
MAX_BLOCKS = 2 ** 31 - 1
# cw, a, q, d, p_max, p_init pointers; p, value out; n_cand; the plan;
# far_grad_tol; the schedule; the counters of runs and of zero pivots (or
# null); stream
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int64, ctypes.c_void_p,
                                      ctypes.c_float, ctypes.c_void_p]
             + [ctypes.c_void_p] * 3)


def p4_geometry(n: int, n_cand: int) -> Tuple[int, int, int]:
    """(bucket, warps a block, blocks) of the kernel's launch for `n_cand`
    candidates of n powers. The bucket is the row width the kernel is
    instantiated at (`csrc/p4_solve.cu`: each lane's row of the Newton
    system in `bucket` registers), n rounded up to a multiple of 4. One
    candidate a warp: candidate c is warp c % WARPS_PER_BLOCK of block
    c // WARPS_PER_BLOCK, and the blocks cover every candidate once.
    Raises where the grid would need more than MAX_BLOCKS blocks."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"p4_solve: n = {n} is not in [1, {MAX_N}]")
    blocks = -(-n_cand // WARPS_PER_BLOCK)
    if blocks > MAX_BLOCKS:
        raise ValueError(f"p4_solve: {n_cand} candidates need {blocks} "
                         f"blocks of {WARPS_PER_BLOCK} warps, above the "
                         f"grid's {MAX_BLOCKS}")
    return -(-n // 4) * 4, WARPS_PER_BLOCK, blocks


def newton_ops(n: int) -> int:
    """fp32 operations of one Newton step of one candidate, as few as
    the step needs: the gradient (25 n), the Hessian's distinct entries
    (it is symmetric; 7 an entry, 3 more on the diagonal), the LU with
    partial pivoting (a reciprocal, the multipliers and the updates of
    each pivot, the right-hand side's forward elimination), the back
    substitution (n^2), the trust region (3 n) and the projection
    (7 n + 10)."""
    lu = n + 3 * n * (n - 1) // 2 + (n - 1) * n * (2 * n - 1) // 3
    return 25 * n + 7 * n * (n + 1) // 2 + 3 * n + lu + n * n \
        + 10 * n + 10


def p4_work(n_cand: int, n: int, newton: int, polish: int, warm: bool,
            adaptive: bool = False) -> Tuple[int, int]:
    """(operations, bytes) of `n_cand` candidates of n powers, each
    applying `newton` Newton steps (`newton_ops`) and `polish` polish
    steps (15 n + 10 each), beside its start and its value (12 n + 12)
    and, when `adaptive`, its seed's gradient norm (7 n + 2): cw, a, q,
    d, p_max (and p_init when `warm`) read once, p and the value
    written once."""
    ops = n_cand * (newton * newton_ops(n) + polish * (15 * n + 10)
                    + 12 * n + 12 + adaptive * (7 * n + 2))
    nbytes = n_cand * 4 * (1 + 4 * n + warm * n + n + 1)
    return ops, nbytes


def barrier_schedule(iters: int, mu_final: float) -> Tuple[float, ...]:
    """The barrier weights of the cold path: `iters` geometrically spaced
    values from 1e-1 down to `mu_final`, each rounded once to fp32 from
    the float64 geometric sequence (the reference calls
    `jnp.geomspace(1e-1, mu_final, iters)` in fp32)."""
    mus = np.geomspace(1e-1, mu_final, iters).astype(np.float32)
    return tuple(float(m) for m in mus)


def _polish_count(n_it: int, iters: int) -> int:
    """Gradient-polish steps for a Newton budget of `n_it` out of the cold
    `iters`: the full 10 at the full budget, proportionally fewer on a
    shortened budget."""
    return 10 if n_it == iters else max(2, (10 * n_it) // iters)


def p4_budget(iters: int, warm: bool, warm_iters: int, far_iters: int,
              far_grad_tol: float):
    """(adaptive, n_it, n_run): whether the two-tier budget is on, the
    Newton steps of the near (or only) tier and of the longest tier."""
    adaptive = (warm and warm_iters > 0 and far_iters > warm_iters
                and far_grad_tol > 0.0)
    n_it = min(int(warm_iters), iters) if warm and warm_iters > 0 \
        else iters
    n_run = min(int(far_iters), iters) if adaptive else n_it
    return adaptive, n_it, n_run


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x * y).sum(-1)


def _outer(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x[..., :, None] * y[..., None, :]


def _phi_grad_hess(p, a, q, cw, d, p_max, mu: float):
    """Barrier objective phi = F + mu * barriers; returns (grad, hess).
    Vectors are [..., n], cw is [...]."""
    s = (1.0 + _dot(a, p))[..., None]
    cw = cw[..., None]
    gF = cw * a / s - q
    HF = -cw[..., None] * _outer(a, a) / (s * s)[..., None]
    # box barriers
    lo = torch.clamp_min(p, 1e-12)
    hi = torch.clamp_min(p_max - p, 1e-12)
    g_lo = mu / lo
    g_hi = -mu / hi
    H_lo = -mu / lo ** 2
    H_hi = -mu / hi ** 2
    # decodability barrier: ln(-d.p), requires d.p < 0
    slack = torch.clamp_min(-_dot(d, p), 1e-12)[..., None]
    g_c = -mu * d / slack
    H_c = -mu * _outer(d, d) / (slack ** 2)[..., None]
    grad = gF + g_lo + g_hi + g_c
    hess = HF + torch.diag_embed(H_lo + H_hi) + H_c
    return grad, hess


def _project_feasible(p, d, p_max, margin: float = 0.999):
    """Clip into the box and scale OPV powers to satisfy d.p <= 0."""
    p = torch.minimum(torch.clamp_min(p, 1e-9), p_max - 1e-9)
    p_m = p[..., 0]
    rest = p[..., 1:]
    # d0 <= 0 when feasible candidate; headroom = -d0 * p_m
    headroom = torch.clamp_min(-d[..., 0] * p_m, 1e-30)
    load = _dot(d[..., 1:], rest)
    scale = torch.clamp_max(margin * headroom / torch.clamp_min(load, 1e-30),
                            1.0)
    return torch.cat([p[..., :1], rest * scale[..., None]], dim=-1)


def seed_grad_norms(cw, a, q, p):
    """The raw objective's gradient norm at each candidate's projected
    seed `p` ([..., n]): the adaptive budget puts a candidate on the far
    tier where it is above `far_grad_tol`."""
    s0 = (1.0 + _dot(a, p))[..., None]
    return torch.linalg.vector_norm(cw[..., None] * a / s0 - q, dim=-1)


def split_far_tol(g0: torch.Tensor) -> float:
    """A `far_grad_tol` in the widest gap of the seeds' gradient norms
    `g0` around their median: both tiers hold candidates, and no norm
    lies near enough to the threshold for the order of a sum (the
    kernel's and PyTorch's differ) to change its tier. For the checks
    that hold the kernel's tiers to the plain version's."""
    g = torch.sort(g0.flatten()).values
    lo, hi = len(g) // 4, 3 * len(g) // 4
    j = lo + int(torch.argmax(g[lo + 1:hi + 1] - g[lo:hi]))
    return float(0.5 * (g[j] + g[j + 1]))


def p4_solve_plain(cw, a, q, d, p_max, p_init=None, *, iters: int = 25,
                   mu_final: float = 1e-3, warm_iters: int = 0,
                   far_iters: int = 0, far_grad_tol: float = 0.0):
    """The same function in plain PyTorch: `core/solver.py solve_p4`'s
    batched solve, one `torch.linalg.solve_ex` of every candidate's
    [..., n, n] system a Newton step. Both tiers of the adaptive budget
    run as masked updates in one loop."""
    n = a.shape[-1]
    adaptive, n_it, n_run = p4_budget(iters, p_init is not None, warm_iters,
                                      far_iters, far_grad_tol)
    if p_init is None:
        p0 = torch.full_like(a, 0.25) * p_max
        p0[..., 0] = 0.5 * p_max[..., 0]
    else:
        p0 = p_init
    p = _project_feasible(p0, d, p_max, margin=0.5)

    if adaptive:
        far = seed_grad_norms(cw, a, q, p) > far_grad_tol
        # the first step a candidate applies, of the Newton loop and of
        # the polish loop
        first = torch.where(far, 0, n_run - n_it)[..., None]
        first_pol = torch.where(
            far, 0, _polish_count(n_run, iters)
            - _polish_count(n_it, iters))[..., None]

    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    step_cap = (0.5 * p_max.amax(-1))[..., None]
    mus = barrier_schedule(iters, float(mu_final))[iters - n_run:]
    for i, mu in enumerate(mus):
        grad, hess = _phi_grad_hess(p, a, q, cw, d, p_max, mu)
        # damped Newton ascent on the concave barrier objective
        hess = hess - 1e-9 * eye
        dlt = torch.linalg.solve_ex(hess, -grad)[0]
        # keep steps inside the trust region of the barrier
        norm = torch.linalg.vector_norm(dlt, dim=-1, keepdim=True)
        dlt = dlt * torch.clamp_max(step_cap / (norm + 1e-12), 1.0)
        p_new = _project_feasible(p + dlt, d, p_max)
        p = torch.where(i >= first, p_new, p) if adaptive else p_new

    # gradient polish: a few projected-ascent steps on the raw objective
    lr_cap = (0.05 * p_max.amax(-1))[..., None]
    for j in range(_polish_count(n_run, iters)):
        s = (1.0 + _dot(a, p))[..., None]
        g = cw[..., None] * a / s - q
        lr = lr_cap / (torch.linalg.vector_norm(g, dim=-1, keepdim=True)
                       + 1e-12)
        p_new = _project_feasible(p + lr * g, d, p_max)
        p = torch.where(j >= first_pol, p_new, p) if adaptive else p_new

    val = cw * torch.log1p(_dot(a, p)) - _dot(q, p)
    # zero-power value as a floor (solver never worse than not transmitting)
    better = val >= 0.0
    p = torch.where(better[..., None], p, 0.0)
    return p, torch.clamp_min(val, 0.0)


@functools.cache
def _launcher():
    """The library and its `p4_solve_f32`, resolved once per process."""
    lib = load_library()
    return lib, lib.function("p4_solve_f32", _ARGTYPES)


def _check(cw, a, q, d, p_max, p_init) -> None:
    """What the kernel takes: float32, contiguous, on one device, a, q, d,
    p_max (and p_init) of one shape [..., n] with n <= MAX_N, cw [...]."""
    n = a.shape[-1] if a.ndim else 0
    if not 1 <= n <= MAX_N:
        raise ValueError(f"p4_solve: n = 1 + U must be in [1, {MAX_N}] "
                         f"(MAX_N: one warp a candidate, a lane a row), got "
                         f"a of shape {tuple(a.shape)}")
    for name, x, shape in (("cw", cw, a.shape[:-1]), ("a", a, a.shape),
                           ("q", q, a.shape), ("d", d, a.shape),
                           ("p_max", p_max, a.shape),
                           ("p_init", p_init, a.shape)):
        if x is None:
            continue
        if x.device != a.device or x.dtype != torch.float32:
            raise ValueError(f"p4_solve: {name} must be torch.float32 on "
                             f"{a.device}, got {x.dtype} on {x.device}")
        if x.shape != shape:
            raise ValueError(f"p4_solve: {name} has shape "
                             f"{tuple(x.shape)}, expected {tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"p4_solve: {name} is not contiguous")


class _P4Solve(DeviceCounts):
    """The kernel's wrapper; `p4_solve` is its one instance.

    `p4_solve(cw, a, q, d, p_max, p_init=None, *, iters, mu_final,
    warm_iters, far_iters, far_grad_tol)` returns (p [..., n], value
    [...]), `core/solver.py solve_p4`'s function.

    `launches` counts the kernel's runs on the card, as the kernel itself
    counts them (`DeviceCounts`), graph replays included; launches made
    under `uncounted()` are not counted. `zero_pivots` counts the
    exactly-zero pivots that the kernel's LU met in the counted launches
    of the whole process: setting `launches` does not reset it.
    """

    def __init__(self):
        super().__init__("p4_solve", slots=2)

    @property
    def zero_pivots(self) -> int:
        return self.read(1)

    def __call__(self, cw, a, q, d, p_max, p_init=None, *, iters: int = 25,
                 mu_final: float = 1e-3, warm_iters: int = 0,
                 far_iters: int = 0, far_grad_tol: float = 0.0):
        """Through the custom operator `torch.ops.repro.p4_solve` where a
        mode must see it (`through_operator`)."""
        check_device("p4_solve", a)
        _check(cw, a, q, d, p_max, p_init)
        args = (cw, a, q, d, p_max, p_init, int(iters), float(mu_final),
                int(warm_iters), int(far_iters), float(far_grad_tol))
        if through_operator(a):
            return torch.ops.repro.p4_solve(*args)
        return _p4_solve_impl(*args)

    def _launch(self, cw, a, q, d, p_max, p_init, iters, mu_final,
                warm_iters, far_iters, far_grad_tol):
        """The operator's implementation on CUDA tensors: the kernel's
        launch with the schedule of the longest tier."""
        n = a.shape[-1]
        adaptive, n_it, n_run = p4_budget(iters, p_init is not None,
                                          warm_iters, far_iters,
                                          far_grad_tol)
        if n_run > MAX_STEPS:
            raise ValueError(f"p4_solve: {n_run} Newton steps, above the "
                             f"kernel's MAX_STEPS {MAX_STEPS}")
        pol_run, pol_it = (_polish_count(n_run, iters),
                           _polish_count(n_it, iters))
        mus = barrier_schedule(iters, mu_final)[iters - n_run:]
        p = torch.empty(a.shape, dtype=torch.float32, device=a.device)
        val = torch.empty(cw.shape, dtype=torch.float32, device=a.device)
        n_cand = cw.numel()
        if n_cand == 0:
            return p, val
        plan = (ctypes.c_int * 9)(n, n_run, n_run - n_it, pol_run,
                                  pol_run - pol_it, int(adaptive),
                                  *p4_geometry(n, n_cand))
        sched = (ctypes.c_float * max(1, n_run))(*mus)
        lib, fn = _launcher()
        with torch.cuda.device(a.device):
            count = self.counts(a.device)
            stream = torch.cuda.current_stream(a.device).cuda_stream
            rc = fn(cw.data_ptr(), a.data_ptr(), q.data_ptr(), d.data_ptr(),
                    p_max.data_ptr(),
                    None if p_init is None else p_init.data_ptr(),
                    p.data_ptr(), val.data_ptr(), n_cand, plan,
                    far_grad_tol, sched,
                    count.data_ptr() if self.counting else None,
                    count[1:].data_ptr() if self.counting else None, stream)
        lib.check(rc, "p4_solve")
        return p, val


p4_solve = _P4Solve()


def _p4_solve_impl(cw: torch.Tensor, a: torch.Tensor, q: torch.Tensor,
                   d: torch.Tensor, p_max: torch.Tensor,
                   p_init: Optional[torch.Tensor], iters: int,
                   mu_final: float, warm_iters: int, far_iters: int,
                   far_grad_tol: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The operator's implementation: the plain version on the CPU, the
    kernel on CUDA."""
    if a.device.type == "cpu":
        return p4_solve_plain(cw, a, q, d, p_max, p_init, iters=iters,
                              mu_final=mu_final, warm_iters=warm_iters,
                              far_iters=far_iters, far_grad_tol=far_grad_tol)
    if a.device.type != "cuda":
        raise ValueError(f"p4_solve: unsupported device {a.device}")
    return p4_solve._launch(cw, a, q, d, p_max, p_init, iters, mu_final,
                            warm_iters, far_iters, far_grad_tol)


_p4_solve_op = torch.library.custom_op(
    "repro::p4_solve", mutates_args=())(_p4_solve_impl)


@_p4_solve_op.register_fake
def _(cw, a, q, d, p_max, p_init, iters, mu_final, warm_iters, far_iters,
      far_grad_tol):
    return (torch.empty_like(a, dtype=torch.float32),
            torch.empty_like(cw, dtype=torch.float32))


def p4_solve_cost(cw, a, q, d, p_max, p_init, iters, mu_final, warm_iters,
                  far_iters, far_grad_tol):
    """(operations, bytes) of the solve (`p4_work`), every candidate
    counted on the longest tier: a fake tensor holds no seed to tell the
    near ones."""
    adaptive, n_it, n_run = p4_budget(iters, p_init is not None, warm_iters,
                                      far_iters, far_grad_tol)
    return p4_work(cw.numel(), a.shape[-1], n_run,
                   _polish_count(n_run, iters), p_init is not None,
                   adaptive)


register_cost(torch.ops.repro.p4_solve, p4_solve_cost)
