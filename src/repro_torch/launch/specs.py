"""One rank's step and inputs for every (arch x input-shape x mesh) case.

Port of `repro/launch/specs.py`. The reference returns the step, its
abstract global inputs and their `NamedSharding`s, and XLA cuts every
input to each device's shard. The port runs one rank of the mesh, so
`build_case` returns the step and this rank's inputs: each tensor of the
shape the reference's sharding gives a device (`local_shape`), under
the same rules (`pick_rules`) and with the same constants. Under a
`FakeTensorMode` the inputs are fake (nothing is allocated: the dry run,
`launch/dryrun.py`); otherwise they are drawn from `seed` on `device`.

Where the reference's sharding would pad a dim that its mesh axes do not
divide, the port refuses the case, naming the dim (`engine.
check_model_axis` does so for the model axis).

The step is the port's own code: `fl/vfl.py:make_train_step` with the
inline VEDS round (train), `engine.forward` with `last_logit_only` and
`seq_shard` (prefill) and `engine.decode_step` (decode). On a mesh of
one rank the step runs as one process (`mesh` None), where a VFL round
holds every vehicle and aggregates them with `fedavg_agg`.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.channel.mobility import ManhattanParams
from repro_torch.channel.v2x import ChannelParams
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.lyapunov import VedsParams
from repro_torch.core.scenario import ScenarioParams, make_round
from repro_torch.core.veds import RoundInputs
from repro_torch.fl.vfl import make_train_step
from repro_torch.models import engine
from repro_torch.models.module import Declared, materialize, tree_map
from repro_torch.sharding.fsdp import layout_axis, pick_layout
from repro_torch.sharding.policy import attention_tp_mode
from repro_torch.sharding.rules import (LogicalRules, default_rules,
                                        fsdp_rules, mesh_shape)

N_OPV = 8
N_SLOTS = 50


def pick_rules(cfg: ModelConfig, mesh) -> LogicalRules:
    """The reference's rules of `cfg` on `mesh`, by its layout
    (`sharding/fsdp.py pick_layout`)."""
    multi_pod = "pod" in mesh_shape(mesh)
    layout = pick_layout(cfg)
    if layout == "fsdp":
        return fsdp_rules(multi_pod=False)  # embed->data; federation on pod
    rules = default_rules(multi_pod=multi_pod)
    if layout == "dp":
        # edge-scale models: replicate params; parallelize the per-vehicle
        # batch over the model axis instead (grad all-reduce over 'model').
        rules = rules.override(
            vocab=None, heads=None, mlp=None, experts=None, row_in=None,
            row_head_dim=None, ssm_heads=None)
    return rules


def effective_vehicles(cfg: ModelConfig, mesh) -> int:
    pods = mesh_shape(mesh).get("pod", 1)
    if cfg.num_vehicles == 1:
        return pods  # federation across pods when available
    return cfg.num_vehicles * pods if pods > 1 else cfg.num_vehicles


def grad_accum(cfg: ModelConfig, b_v: int) -> int:
    """The reference's search: the largest count <= cfg.grad_accum that
    divides the per-vehicle batch."""
    ga = min(cfg.grad_accum, b_v)
    while b_v % ga:
        ga -= 1
    return ga


def _data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))


def _batch_entry(mesh, b: int):
    axes = _data_axes(mesh)
    total = math.prod(mesh_shape(mesh)[a] for a in axes)
    if b % total == 0:
        return axes if len(axes) > 1 else axes[0]
    return None


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape, spec, mesh, what: str = "") -> Tuple[int, ...]:
    """A tensor's shape on one rank under `spec` (one entry a dim: None,
    a mesh axis or a tuple of them): each dim divided by its axes' ranks.
    Raises where they do not divide it (the reference would pad)."""
    sizes = mesh_shape(mesh)
    out = []
    for dim, (n, entry) in enumerate(zip(shape, tuple(spec) + (None,) * (
            len(shape) - len(spec)))):
        k = math.prod(sizes[a] for a in _axes(entry))
        if n % k:
            raise ValueError(
                f"{what} dim {dim} of {n} does not split over the {k} ranks "
                f"of {_axes(entry)}; the reference would pad it, the port "
                f"refuses it")
        out.append(n // k)
    return tuple(out)


def _fake() -> bool:
    from torch._guards import detect_fake_mode
    return detect_fake_mode() is not None


def _untraced():
    """A block outside any fake mode: the mesh's own bookkeeping (its
    groups and coordinates, the flattened vehicle group) reads its real
    tensors there."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    return unset_fake_temporarily()


class _Leaves:
    """Makes this rank's input tensors: empty under a fake mode, drawn
    from one generator otherwise (the reference's initialisers for
    declared parameters)."""

    def __init__(self, device, seed: int):
        self.device = device
        self.fake = _fake()
        self.gen = None if self.fake else torch.Generator(
            device=device).manual_seed(seed)

    def declared(self, d: Declared, shape) -> torch.Tensor:
        if self.fake:
            return torch.empty(shape, dtype=d.dtype, device=self.device)
        return materialize(self.gen, Declared(shape, (), d.init, d.scale,
                                              d.dtype))

    def tokens(self, shape, vocab: int) -> torch.Tensor:
        if self.fake:
            return torch.empty(shape, dtype=torch.int32, device=self.device)
        return torch.randint(0, vocab, shape, generator=self.gen,
                             device=self.device, dtype=torch.int32)

    def normal(self, shape, dtype) -> torch.Tensor:
        if self.fake:
            return torch.empty(shape, dtype=dtype, device=self.device)
        return (0.1 * torch.randn(shape, generator=self.gen,
                                  device=self.device)).to(dtype)


def _local_tree(leaves: _Leaves, decl, rules: LogicalRules, mesh,
                prefix=(), lead=()):
    """This rank's blocks of a declared tree under `rules`, each with
    `lead` (global size, spec entry) dims in front."""
    def one(d: Declared):
        spec = tuple(e for _, e in lead) + rules.spec(d.axes)
        shape = local_shape(tuple(n for n, _ in lead) + d.shape, spec, mesh,
                            f"{'/'.join(prefix)} {d.axes}")
        return leaves.declared(d, shape)
    return tree_map(one, decl)


def build_case(cfg: ModelConfig, shape: ShapeConfig, mesh, device=None, *,
               seed: int = 0, with_step: bool = True
               ) -> Tuple[Callable, tuple]:
    """(step, args): this rank's step of the case and its inputs, on
    `device` (CUDA unless named). `mesh`: a `DeviceMesh` over the world
    this rank belongs to (a fake one in the dry run), or an `{axis: size}`
    mapping of one rank. With `with_step` False the step is None (the
    inputs alone)."""
    device = resolve_device(device)
    sizes = mesh_shape(mesh)
    tp = attention_tp_mode(cfg.num_heads, sizes.get("model", 1))
    rules = pick_rules(cfg, mesh)
    decl = engine.model_decl(cfg, tp)
    leaves = _Leaves(device, seed)
    one_rank = math.prod(sizes.values()) == 1
    step_mesh = None if one_rank else mesh
    layout = pick_layout(cfg)
    step = None

    if shape.kind == "train":
        V = effective_vehicles(cfg, mesh)
        b_v = shape.global_batch // V
        if b_v < 1:
            raise ValueError(f"global batch {shape.global_batch} over {V} "
                             f"vehicles")
        cfg_v = cfg.replace(num_vehicles=V, grad_accum=grad_accum(cfg, b_v))
        veh_axes = () if V == 1 else (
            ("pod",) if cfg.num_vehicles == 1 else _data_axes(mesh))
        veh = (veh_axes if len(veh_axes) > 1 else
               (veh_axes[0] if veh_axes else None))
        params_v = _local_tree(leaves, decl, rules, mesh, lead=((V, veh),))
        M = sizes.get("model", 1)
        if V == 1:
            inner = "data"
        elif cfg.sharding_profile == "dp" and b_v % M == 0:
            inner = "model"  # dp profile: per-vehicle batch over model axis
        else:
            inner = None
        bshape = local_shape((V, b_v, shape.seq_len), (veh, inner, None),
                             mesh, "batch")
        batch = {"tokens": leaves.tokens(bshape, cfg.vocab_size),
                 "labels": leaves.tokens(bshape, cfg.vocab_size)}
        if cfg.family in ("vlm", "audio"):
            batch["src"] = leaves.normal(
                local_shape((V, b_v, cfg.num_src_tokens, cfg.src_dim),
                            (veh, inner), mesh, "src"), cfg.dtype)
        rows = bshape[1]
        if rows % cfg_v.grad_accum:
            raise ValueError(f"{rows} rows of a vehicle's batch on a rank "
                             f"do not split into {cfg_v.grad_accum} "
                             f"microbatches")
        veds_prm = VedsParams(Q=8 * 4e9 / max(V, 2), slot=0.1)
        ch_prm = ChannelParams()
        rnd = _round_inputs(leaves, V, veds_prm, ch_prm)
        weights = torch.ones((V,), dtype=torch.float32, device=device) \
            if not leaves.fake else torch.empty((V,), device=device)
        if with_step:
            with _untraced():
                step = make_train_step(
                    cfg_v, step_mesh, tp, lr=0.1, inline_scheduler=True,
                    veds_prm=veds_prm, ch_prm=ch_prm, layout=layout,
                    split_batch=inner is not None)
        return step, (params_v, batch, rnd, weights)

    if shape.kind == "prefill":
        b_entry = _batch_entry(mesh, shape.global_batch)
        params = _local_tree(leaves, decl, rules, mesh)
        tokens = leaves.tokens(local_shape(
            (shape.global_batch, shape.seq_len), (b_entry,), mesh, "tokens"),
            cfg.vocab_size)
        args = [params, tokens]
        if cfg.family in ("vlm", "audio"):
            args.append(leaves.normal(local_shape(
                (shape.global_batch, cfg.num_src_tokens, cfg.src_dim),
                (b_entry,), mesh, "src"), cfg.dtype))
        with _untraced():
            ax = layout_axis(step_mesh, layout)

        def step(params, tokens, src=None):
            # serving prefill returns only the last position's logits
            logits, _ = engine.forward(params, tokens, cfg, tp=tp, src=src,
                                       last_logit_only=True, seq_shard=True,
                                       mesh=ax)
            return logits
        return (step if with_step else None), tuple(args)

    # decode (under the dp profile the parameters replicated, each cache's
    # sequence dim over the model axis: `layout_axis`'s cache axis)
    force_swa = (shape.seq_len > 100_000
                 and cfg.long_context_variant == "swa")
    B = shape.global_batch
    b_entry = _batch_entry(mesh, B)
    cache_decl_ = engine.cache_decl(cfg, B, shape.seq_len,
                                    force_swa=force_swa)
    # batch axis of caches follows the data axes when divisible
    c_rules = rules.override(batch=b_entry) if b_entry else \
        rules.override(batch=None)
    cache = _local_tree(leaves, cache_decl_, c_rules, mesh, ("cache",))
    params = _local_tree(leaves, decl, rules, mesh)
    tokens = leaves.tokens(local_shape((B,), (b_entry,), mesh, "tokens"),
                           cfg.vocab_size)
    pos = torch.full((), shape.seq_len // 2, dtype=torch.int32,
                     device=device) if not leaves.fake else \
        torch.empty((), dtype=torch.int32, device=device)
    with _untraced():
        ax = layout_axis(step_mesh, layout)

    def step(params, cache, tokens, pos):
        return engine.decode_step(params, cache, tokens, pos, cfg, ax,
                                  tp=tp, force_swa=force_swa)
    return (step if with_step else None), (params, cache, tokens, pos)


def _round_inputs(leaves: _Leaves, V: int, prm: VedsParams,
                  ch: ChannelParams) -> RoundInputs:
    """The round's gains and budgets ([N_SLOTS, V] and such, replicated
    on every rank): a scenario draw of V SOVs and N_OPV OPVs, or empty
    tensors of those shapes under a fake mode."""
    if leaves.fake:
        f = dict(dtype=torch.float32, device=leaves.device)
        return RoundInputs(
            g_sr=torch.empty((N_SLOTS, V), **f),
            g_or=torch.empty((N_SLOTS, N_OPV), **f),
            g_so=torch.empty((N_SLOTS, V, N_OPV), **f),
            t_cp=torch.empty((V,), **f), e_cp=torch.empty((V,), **f),
            e_sov=torch.empty((V,), **f), e_opv=torch.empty((N_OPV,), **f))
    sc = ScenarioParams(n_sov=V, n_opv=N_OPV, n_slots=N_SLOTS)
    return make_round(leaves.gen, sc, ManhattanParams(), ch, prm)

