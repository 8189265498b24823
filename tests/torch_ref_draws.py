"""The reference's own random draws, regenerated from its `jax.random`
keys in the layout of the port's `*_draws` functions, so the port's
deterministic steps can be fed exactly what the reference consumed.

Each function mirrors where the reference splits its key: `init_mobility`
(k1..k4 = split(key, 4), speed from fold_in(key, 9)), `step_mobility`
(the turn uniform from the key, the heading bits from fold_in(key, 1)
and fold_in(key, 2)), `channel_gain` (k1..k5 = split(key, 5); a
bernoulli(k, p) is uniform(k) < p), and the scenario builders above
them. Shared by `test_torch_streaming.py` and `test_torch_fused.py`."""
import functools

import jax
import numpy as np
import torch

from torch_port_util import tt


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
