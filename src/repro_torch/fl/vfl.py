"""The VFL round: per-vehicle local SGD of an LLM, then the masked
weighted aggregation that the VEDS scheduler gates.

Port of `repro/fl/vfl.py` on one device. Each vehicle holds its own
model replica: every parameter leaf has a leading [V] axis. One round:

  1. local SGD (eq. 2): each vehicle's gradient over its local batch,
     accumulated over `cfg.grad_accum` microbatches, one vehicle after
     the other into a stacked `new_v`;
  2. upload/aggregate (eq. 11): `fedavg_agg_tree(new_v, mask * weights,
     old)`, the one-device form of the reference's psum over the vehicle
     axes. Failed vehicles (mask 0) contribute nothing; if every upload
     fails the previous global model is kept. On a CUDA device the
     aggregation is the `fedavg_agg` kernel.

The aggregate comes back broadcast to [V] as a view (no copy). V = 1 is
the reference's scalar-mask branch. `make_train_step(stream=...)` is the
whole-run step: the run's scheduling (`stream_rounds`) and then its VFL
rounds.

With a mesh (a `DeviceMesh` over an initialized world, or its `{axis:
size}` mapping) the vehicles are the ranks of the mesh's vehicle axes
(`vehicle_axes`, the reference's rule): each rank holds one vehicle's
replica ([1, ...] leaves), runs its local SGD and aggregates with two
all-reduces over those axes, as the reference's shard_map body psums:
den = sum of the weights, num = sum of fp32(x) * w / max(den, 1e-9),
the old leaf kept where den = 0, cast to the leaf's dtype.

On a (V, M) ("data", "model") mesh, or a (P, D, M) ("pod", "data",
"model") one with the vehicles over (pod, data), each rank holds its
vehicle's block of the model (`sharding.model_axis.shard_params`), runs
its local SGD with the model axis's collectives (the vocab-parallel loss
included) and aggregates over the vehicle group of its model coordinate:
the same two all-reduces, leaf block by leaf block. Every replicated
leaf gets its whole gradient on every rank, so the ranks of a vehicle
keep equal copies.

Two more layouts of a vehicle's ranks (`sharding/fsdp.py pick_layout`,
the reference's `launch/specs.py:pick_rules`): under FSDP (the
one-vehicle configs) the parameters' `embed` dims are split over the
data axis and gathered on use, the batch split over it too when the
round federates one vehicle; under the `dp` profile the parameters are
replicated over the model axis and each vehicle's batch is split over
it, the gradient all-reduced over it.
"""
from __future__ import annotations

import functools
from typing import Callable, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.veds import veds_round
from repro_torch.kernels.fedavg_agg.ops import fedavg_agg_tree
from repro_torch.launch.op_costs import loop
from repro_torch.models import engine
from repro_torch.models import layers as L
from repro_torch.models.module import tree_leaves, tree_map, tree_unflatten
from repro_torch.sharding.fsdp import average_grads, layout_axis, \
    pick_layout
from repro_torch.sharding.model_axis import LOCAL, model_axis
from repro_torch.sharding.rules import mesh_shape


def vehicle_axes(mesh, num_vehicles: int) -> Tuple[str, ...]:
    """Mesh axes that carry the federation dimension: none for one
    vehicle, else the pod axis, the data axis or both, whichever has
    `num_vehicles` ranks (the reference's rule; a model axis beside them
    splits each vehicle's model). `mesh` None is one process holding
    every vehicle."""
    if mesh is None:
        return ()
    sizes = mesh_shape(mesh)
    data, pod = sizes.get("data", 1), sizes.get("pod", 1)
    if num_vehicles == 1:
        return ()
    if num_vehicles == pod:
        return ("pod",)
    if num_vehicles == data:
        return ("data",)
    if num_vehicles == pod * data and pod > 1:
        return ("pod", "data")
    raise ValueError(
        f"num_vehicles={num_vehicles} incompatible with mesh {sizes}")


def _vehicle_group(mesh, v_axes):
    """(process group, this rank's vehicle index) of the vehicle axes:
    one axis's group, or over ("pod", "data") the flattened group of the
    ranks that share this rank's model coordinate (index pod * data +
    data, the reference's flattened vehicle index). A mapping is one
    world of vehicles."""
    if isinstance(mesh, Mapping):
        return dist.group.WORLD, dist.get_rank()
    if len(v_axes) == 1:
        return mesh.get_group(v_axes[0]), mesh.get_local_rank(v_axes[0])
    sub = mesh[v_axes]._flatten()
    return sub.get_group(), sub.get_local_rank()


def lm_loss(params, batch, cfg: ModelConfig, tp: str,
            mesh=None) -> torch.Tensor:
    """The LM loss (+ 0.01 the MoE aux loss); over a model axis
    (`mesh`) vocab-parallel, from this rank's logit columns."""
    logits, aux = engine.forward(params, batch["tokens"], cfg, tp=tp,
                                 src=batch.get("src"), mesh=mesh,
                                 gather_logits=False)
    loss = L.softmax_cross_entropy(logits, batch["labels"], mesh=mesh)
    return loss + 0.01 * aux


def _local_sgd(params, batch, cfg: ModelConfig, tp: str,
               loss_fn: Callable, lr: float, out=None, mesh=None):
    """One FL local update (eq. 2) with microbatch gradient accumulation.
    With `out` (a tree of tensors shaped like `params`), the new
    parameters are written there and `out` is returned. Over a model
    axis (`mesh`) `params` is this rank's block and `loss_fn` takes
    `mesh=`."""
    A = max(cfg.grad_accum, 1)
    ax = model_axis(mesh)
    if ax != LOCAL:
        loss_fn = functools.partial(loss_fn, mesh=ax)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tree = tree_unflatten(params, leaves)
    acc = None
    for a in loop("microbatches", A):
        mb = {k: x.reshape(A, x.shape[0] // A, *x.shape[1:])[a]
              for k, x in batch.items()}
        g = torch.autograd.grad(loss_fn(tree, mb, cfg, tp), leaves)
        acc = list(g) if acc is None else [s + gi for s, gi in zip(acc, g)]
    if ax.fsdp is not None or ax.batch is not None:
        acc = average_grads(
            acc, tree_leaves(engine.fsdp_dims(cfg, tp)[0]), ax)
    dst = [None] * len(leaves) if out is None else tree_leaves(out)
    new = []
    for i, p in enumerate(leaves):
        step = lr * acc[i] / A
        acc[i] = None                     # free the gradient as we go
        if dst[i] is None:
            new.append((p.detach() - step).to(p.dtype))
        else:
            new.append(torch.sub(p.detach(), step, out=dst[i]))
    return tree_unflatten(params, new)


def _vehicle(tree, v: int):
    return tree_map(lambda x: x[v], tree)


def make_vfl_round(cfg: ModelConfig, mesh=None, tp: str = "head", *,
                   loss_fn: Callable = lm_loss, lr: float = 0.1,
                   stage_hook: Optional[Callable[[str], None]] = None,
                   layout: Optional[str] = None, split_batch: bool = True):
    """Builds round_fn(params_v, batch_v, mask, weights) -> params_v.

    params_v: leading [V] axis; batch_v leaves [V, b, ...];
    mask/weights: [V] (success indicators from the scheduler; |D_m|
    weights). `stage_hook(name)`, if given, is called after the
    "local_sgd" and "aggregate" stages (a caller may time them). Over
    the vehicle axes of a mesh (`vehicle_axes`), params_v and batch_v
    hold this rank's vehicle ([1, ...] leaves), over a model axis its
    block of the vehicle's model. `layout` (`sharding/fsdp.py
    pick_layout` of `cfg` unless named) and `split_batch` choose the
    layout of a vehicle's ranks (`layout_axis`): under "fsdp" params_v
    hold this rank's FSDP block (`shard_params(..., fsdp_rules())`), and
    batch_v its rows of the vehicle's batch where the batch is split."""
    V = cfg.num_vehicles
    layout = layout or pick_layout(cfg)
    if mesh is not None and layout != "dp":
        engine.check_model_axis(cfg, tp, mesh_shape(mesh).get("model", 1))
    ax = layout_axis(mesh, layout, split_batch)
    v_axes = vehicle_axes(mesh, V)
    hook = stage_hook or (lambda name: None)

    if v_axes:
        group, idx = _vehicle_group(mesh, v_axes)

        def round_fn(params_v, batch_v, mask, weights):
            p = _vehicle(params_v, 0)
            new = _local_sgd(p, _vehicle(batch_v, 0), cfg, tp, loss_fn, lr,
                             mesh=ax)
            hook("local_sgd")
            w = (mask[idx] * weights[idx]).to(torch.float32)
            den = w.clone()
            dist.all_reduce(den, group=group)
            scale = w / torch.clamp_min(den, 1e-9)

            def agg(old, x):
                num = x.to(torch.float32) * scale
                dist.all_reduce(num, group=group)
                return torch.where(den > 0, num, old.to(torch.float32)).to(
                    old.dtype)

            out = tree_map(agg, p, new)
            hook("aggregate")
            return tree_map(lambda x: x[None], out)
        return round_fn

    if V == 1:
        def round_fn(params_v, batch_v, mask, weights):
            p = _vehicle(params_v, 0)
            new = _local_sgd(p, _vehicle(batch_v, 0), cfg, tp, loss_fn, lr,
                             mesh=ax)
            hook("local_sgd")
            m = (mask[0] * weights[0] > 0).to(torch.float32)
            # (nw - old) in the params' dtype, the rest in float32, as
            # the reference's type promotion does
            out = tree_map(
                lambda old, nw: (old.to(torch.float32) + m * (nw - old).to(
                    torch.float32)).to(old.dtype), p, new)
            hook("aggregate")
            return tree_map(lambda x: x[None], out)
        return round_fn

    def round_fn(params_v, batch_v, mask, weights):
        old = _vehicle(params_v, 0)
        new_v = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                               device=x.device), params_v)
        for v in loop("vehicles", V):
            _local_sgd(_vehicle(params_v, v), _vehicle(batch_v, v), cfg, tp,
                       loss_fn, lr, out=_vehicle(new_v, v))
        hook("local_sgd")
        w = (mask * weights).to(torch.float32)
        agg = fedavg_agg_tree(new_v, w, old)
        hook("aggregate")
        return tree_map(lambda x: x.unsqueeze(0).expand(V, *x.shape), agg)

    return round_fn


def make_train_step(cfg: ModelConfig, mesh=None, tp: str = "head", *,
                    lr: float = 0.1, inline_scheduler: bool = False,
                    veds_prm=None, ch_prm=None, stream=None, sched=None,
                    sc=None, mob=None,
                    stage_hook: Optional[Callable[[str], None]] = None,
                    layout: Optional[str] = None,
                    split_batch: bool = True):
    """Train step: (params_v, batch_v, round_inputs, weights) ->
    (params_v, stats).

    With inline_scheduler, the round's scheduling (Algorithm 2: `sched`,
    or `veds_round` when it is None) runs first and its success mask
    gates the aggregation. `stage_hook` is called after "schedule" and
    after the round's own stages.

    With `stream` (a `repro_torch.core.streaming.StreamConfig`, plus the
    scenario and mobility params `sc`/`mob` and optionally a `sched`
    scheduler), the returned step is the whole run instead:

        run(params_v, batches_v, weights, key) -> params_v, stats

    where `batches_v` entries are [R, V, b, ...] (one per-vehicle batch
    a round) and `key` is the run's seed. The scheduling of all R rounds
    (`stream_rounds`) runs first, then the R VFL rounds gated by its
    masks; `stats` holds `n_success` [R] and `mask` [R, V]. Over a
    mesh's vehicle axes every rank schedules the same run and takes the
    masks of cell 0; `batches_v` hold this rank's vehicle."""
    round_fn = make_vfl_round(cfg, mesh, tp, lr=lr, stage_hook=stage_hook,
                              layout=layout, split_batch=split_batch)
    hook = stage_hook or (lambda name: None)
    V = cfg.num_vehicles

    if stream is not None:
        from repro_torch.core.baselines import get_scheduler
        from repro_torch.core.streaming import stream_rounds
        sched = sched if sched is not None else get_scheduler("veds")
        if int(stream.batch) != 1:
            # the step trains ONE federation; masks come from cell 0
            raise ValueError(
                f"make_train_step(stream=...) needs batch=1 cells, got "
                f"batch={stream.batch}")
        if sc.n_sov < V:
            raise ValueError(
                f"stream scenario schedules n_sov={sc.n_sov} SOVs but the "
                f"mesh federates num_vehicles={V}")

        def run(params_v, batches_v, weights, key):
            res = stream_rounds(key, sched, sc, mob, ch_prm, veds_prm,
                                stream, device=weights.device)
            masks = res.outputs.success[:, 0, :V].to(torch.float32)
            hook("schedule")
            for r in range(masks.shape[0]):
                params_v = round_fn(params_v, {k: x[r] for k, x in
                                               batches_v.items()},
                                    masks[r], weights)
            return params_v, {"n_success": res.outputs.n_success[:, 0],
                              "mask": masks}

        return run

    def step(params_v, batch_v, rnd, weights):
        if inline_scheduler:
            out = (sched or veds_round)(rnd, veds_prm, ch_prm)
            mask = out["success"].to(torch.float32)[:V]
            n_succ = out["n_success"]
        else:
            mask = torch.ones((V,), dtype=torch.float32,
                              device=weights.device)
            n_succ = torch.tensor(V, device=weights.device)
        hook("schedule")
        new_params = round_fn(params_v, batch_v, mask, weights)
        return new_params, {"n_success": n_succ, "mask": mask}

    return step
