"""The reference's own random draws, regenerated from its `jax.random`
keys in the layout of the port's `*_draws` functions, so the port's
deterministic steps can be fed exactly what the reference consumed.

Each function mirrors where the reference splits its key: `init_mobility`
(k1..k4 = split(key, 4), speed from fold_in(key, 9)), `step_mobility`
(the turn uniform from the key, the heading bits from fold_in(key, 1)
and fold_in(key, 2)), `channel_gain` (k1..k5 = split(key, 5); a
bernoulli(k, p) is uniform(k) < p), and the scenario builders above
them. Shared by `test_torch_streaming.py` and `test_torch_fused.py`.

Below them, the scheduling service fed those draws (`RefDrawService`)
and the checks that hold its responses and stored carries against the
reference's, shared by `test_torch_serve.py` and
`test_torch_serve_front.py`: masks and `n_success` identical; losses
within rtol `LOSS_RTOL`, each session's params within `PARAM_RTOL` of
their largest entry, queues within `QUEUE_TOL`, the P4 table within
`TABLE_ATOL` W (with the same entries moved off the seed), the other
fleet fields equal (positions within 1e-4 m)."""
import dataclasses
import functools
import zlib

import jax
import numpy as np
import torch

from repro.launch import serve as J
from repro_torch.core.solver import p4_seed_table
from repro_torch.fl.engine import ClientShards, init_carry
from repro_torch.launch import serve as P
from torch_port_util import tn, tt

LOSS_RTOL = PARAM_RTOL = 1e-5
QUEUE_TOL = dict(rtol=1e-4, atol=1e-6)
TABLE_ATOL = 2e-5


def _t(tree):
    """numpy/JAX leaves as CPU tensors (integers as int64)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return tt(a, torch.int64 if a.dtype.kind in "iu" else None)


def mob_init(key, n, mob):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    n_lines = int(mob.extent // mob.block) + 1  # reprolint: disable=host-sync-in-jit -- static params, not traced
    return {"line": jax.random.randint(k1, (n,), 0, n_lines),
            "offset": jax.random.uniform(k2, (n,), minval=0.0,
                                         maxval=mob.extent),
            "horiz": jax.random.uniform(k3, (n,)) < 0.5,
            "d_bit": jax.random.randint(k4, (n,), 0, 2),
            "speed": jax.random.uniform(
                jax.random.fold_in(key, 9), (n,), minval=0.3 * mob.v_max,
                maxval=max(mob.v_max, 1e-3))}


def mob_steps(key, n_steps, n):
    """[T, n] draws of `rollout_positions(key, ...)`."""
    return jax.vmap(lambda k: {
        "u_turn": jax.random.uniform(k, (n,)),
        "bit_h": jax.random.randint(jax.random.fold_in(k, 1), (n,), 0, 2),
        "bit_v": jax.random.randint(jax.random.fold_in(k, 2), (n,), 0, 2)})(
            jax.random.split(key, n_steps))


def channel(key, shape):
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    return {"u_los": jax.random.uniform(k1, shape),
            "u_blocked": jax.random.uniform(k2, shape),
            "z_block": jax.random.normal(k3, shape),
            "z_shadow": jax.random.normal(k4, shape),
            "fading": jax.random.exponential(k5, shape)}


def init_fleet(key, sc, mob, B, n_fleet=None):
    """The draws of `init_fleet(key, sc, mob, B, n_fleet=...)`."""
    return _t(_init_fleet(key, sc, mob, B, n_fleet))


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _init_fleet(key, sc, mob, B, n_fleet):
    N = n_fleet or 2 * (sc.n_sov + sc.n_opv)
    k_cell, k_rsu, k_j, k_a = jax.random.split(key, 4)
    return {
        "rsu": jax.random.uniform(k_rsu, (B, 2), minval=0.25 * mob.extent,
                                  maxval=0.75 * mob.extent),
        "init": jax.vmap(lambda k: mob_init(k, N, mob))(
            jax.random.split(k_cell, B)),
        "jitter": jax.random.uniform(k_j, (B, N), minval=0.8, maxval=1.2),
        "allowance": jax.random.uniform(k_a, (B, N), minval=sc.e_min,
                                        maxval=sc.e_max)}


def fleet_round(key, sc, B, N):
    """The draws of `fleet_round(key, fleet, ...)` for B cells of N."""
    return _t(_fleet_round(key, sc, B, N))


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _fleet_round(key, sc, B, N):
    S, U, T = sc.n_sov, sc.n_opv, sc.n_slots

    def cell(kb):
        k_mob, k_ch = jax.random.split(kb)
        ks = jax.random.split(k_ch, 3)
        return {"steps": mob_steps(k_mob, T, N),
                "g_sr": channel(ks[0], (T, S)),
                "g_or": channel(ks[1], (T, U)),
                "g_so": channel(ks[2], (T, S, U))}
    return jax.vmap(cell)(jax.random.split(key, B))


def round_batch(key, sc, mob, B):
    """The draws of `make_round_batch(key, sc, mob, ch, prm, B)`."""
    return _t(_round_batch(key, sc, mob, B))


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _round_batch(key, sc, mob, B):
    S, U, T = sc.n_sov, sc.n_opv, sc.n_slots
    k_cell, k_rsu, k_s, k_u = jax.random.split(key, 4)

    def cell(k):
        k_mob, k_ch, k_e, k_cp = jax.random.split(k, 4)
        ks = jax.random.split(k_ch, 3)
        return {
            "init": mob_init(k_mob, S + U, mob),
            "steps": mob_steps(jax.random.fold_in(k_mob, 1), T, S + U),
            "g_sr": channel(ks[0], (T, S)), "g_or": channel(ks[1], (T, U)),
            "g_so": channel(ks[2], (T, S, U)),
            "jitter": jax.random.uniform(k_cp, (S,), minval=0.8,
                                         maxval=1.2),
            "e_sov": jax.random.uniform(k_e, (S,), minval=sc.e_min,
                                        maxval=sc.e_max),
            "e_opv": jax.random.uniform(jax.random.fold_in(k_e, 1), (U,),
                                        minval=sc.e_min, maxval=sc.e_max)}
    out = jax.vmap(cell)(jax.random.split(k_cell, B))
    out.update(
        rsu=jax.random.uniform(k_rsu, (B, 2), minval=0.25 * mob.extent,
                               maxval=0.75 * mob.extent),
        s_cnt=jax.random.randint(k_s, (B,), (S + 1) // 2, S + 1),
        u_cnt=jax.random.randint(k_u, (B,), (U + 1) // 2, U + 1))
    return out


def stream_persistent(key, sc, mob, B, R, n_fleet=None):
    """(fleet draws, [R] round draws) of a persistent `stream_rounds(key,
    ...)`: the fleet from fold_in(key, 0xF1EE7), round r from
    split(key, R)[r]."""
    N = n_fleet or 2 * (sc.n_sov + sc.n_opv)
    return (init_fleet(jax.random.fold_in(key, 0xF1EE7), sc, mob, B,
                       n_fleet),
            [fleet_round(k, sc, B, N) for k in jax.random.split(key, R)])


def trajectory_batch(key, b, num_map_nodes=64):
    """The draws of `make_trajectory_batch(key, b, num_map_nodes)`
    (k1..k5 = split(key, 5): speed k1, heading k2, turn rate k3, map
    offsets k4, acceleration k5)."""
    return _t(_trajectory_batch(key, b, num_map_nodes))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _trajectory_batch(key, b, num_map_nodes):
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    return {
        "speed": jax.random.uniform(k1, (b, 1), minval=3.0, maxval=15.0),
        "heading0": jax.random.uniform(k2, (b, 1), minval=0.0,
                                       maxval=2 * jax.numpy.pi),
        "curls": jax.random.normal(k3, (b, 1)) * 0.05,
        "accel": jax.random.normal(k5, (b, 1)) * 0.05,
        "off": jax.random.normal(k4, (b, num_map_nodes, 2)) * 2.0}


# ---- the scheduling service ------------------------------------------------

class RefDrawService(P.SchedulingService):
    """The port's service fed the reference's data and draws: the
    reference's `default_problem` arrays, each session's fleet from the
    reference's session key, and each request's round draws, selections
    and minibatch uniforms from the reference's `_padded_draws`.
    `mb_shift` rolls a request's minibatch draws by that many rounds (a
    wrong port, for the tolerance tests)."""

    def __init__(self, cfg, jsvc, mb_shift=0):
        self.jsvc, self.mb_shift = jsvc, mb_shift
        _, _, shards = J.default_problem(cfg.n_clients)
        data = {k: tt(v, torch.int64 if k == "y" else None)
                for k, v in shards.data.items()}
        super().__init__(
            cfg, params={"w": torch.zeros(8, 3)},
            loss_fn=P._linear_softmax_loss,
            client_data=ClientShards(data, tt(shards.n_samples)),
            device="cpu")
        self.N = cfg.n_fleet or 2 * (cfg.n_sov + cfg.n_opv)

    def _new_carry(self, session):
        k = jax.random.fold_in(jax.random.key(self.cfg.seed),
                               zlib.crc32(session.encode()))
        draws = init_fleet(jax.random.fold_in(k, 0xF1EE7), self.jsvc.sc,
                              self.jsvc.mob, 1, self.cfg.n_fleet)
        return init_carry(draws, self.sc, self.mob,
                          dataclasses.replace(self._stream, batch=1),
                          self.params0, ch=self.ch, device="cpu")

    def _column(self, req, L):
        keys, sel, mb_u, act = J._padded_draws(
            int(req.n_rounds), L, self.shards.n_clients, self.cfg.n_sov,
            self.cfg.batch_size)(int(req.seed))
        mb_u = torch.roll(tt(mb_u), self.mb_shift, 0)
        return ([fleet_round(k, self.jsvc.sc, 1, self.N) for k in keys],
                tt(sel, torch.int64), mb_u, np.asarray(act))


def check_decisions(ref, ours):
    for rw, ow in zip(ref, ours):
        for r, o in zip(rw, ow):
            np.testing.assert_array_equal(o.success, r.success)
            np.testing.assert_array_equal(o.n_success, r.n_success)


def check_loss(ref, ours):
    for rw, ow in zip(ref, ours):
        for r, o in zip(rw, ow):
            np.testing.assert_allclose(o.loss, r.loss, rtol=LOSS_RTOL,
                                       atol=0)


def check_params(jsvc, svc):
    for s in jsvc.sessions:
        a = np.asarray(jsvc.sessions[s].params["w"])
        b = tn(svc.sessions[s].params["w"])
        assert np.max(np.abs(a - b)) <= PARAM_RTOL * np.max(np.abs(a)), s


def check_queues(jsvc, svc, parted=()):
    """Every stored queue within `QUEUE_TOL` of the reference's, except
    the (session, vehicle) entries of `parted`, which must part from it
    by more (a known case where the reference parts from itself)."""
    skip = np.zeros((len(parted),), bool)
    for s in jsvc.sessions:
        ours = tn(svc.sessions[s].sched.queue).copy()
        ref = np.asarray(jsvc.sessions[s].sched.queue).copy()
        for i, (ps, v) in enumerate(parted):
            if ps == s:
                skip[i] = not np.allclose(ours[..., v], ref[..., v],
                                          **QUEUE_TOL)
                ours[..., v] = ref[..., v]
        np.testing.assert_allclose(ours, ref, **QUEUE_TOL, err_msg=s)
    assert skip.all(), ("these queues no longer part from the reference",
                        [p for p, k in zip(parted, skip) if not k])


def check_table(jsvc, svc):
    """The P4 table as ROADMAP queue 3 holds it: the same entries moved
    off the seed, each within TABLE_ATOL W of the reference's."""
    for s in jsvc.sessions:
        a = np.asarray(jsvc.sessions[s].sched.p4_tab)
        b = tn(svc.sessions[s].sched.p4_tab)
        seed = tn(p4_seed_table(b.shape, svc.ch.p_max, device="cpu"))
        np.testing.assert_array_equal(b != seed, a != seed, err_msg=s)
        np.testing.assert_allclose(b, a, rtol=0, atol=TABLE_ATOL,
                                   err_msg=s)


def check_fleet(jsvc, svc):
    for s in jsvc.sessions:
        ref, ours = jsvc.sessions[s].sched, svc.sessions[s].sched
        for f in ("dir", "speed", "jitter", "allowance", "energy", "rsu_xy",
                  "covered", "cell_id"):
            np.testing.assert_array_equal(tn(getattr(ours, f)),
                                          np.asarray(getattr(ref, f)),
                                          err_msg=f)
        np.testing.assert_allclose(tn(ours.pos), np.asarray(ref.pos),
                                   rtol=0, atol=1e-4)
