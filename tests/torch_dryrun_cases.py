"""The ranks' side of `tests/test_torch_dryrun.py` and
`tests/test_torch_fsdp.py`: functions run by each rank of a gloo world
(`launch.mesh.run_world`), saving their results for the parent test to
check. Imports no jax: the ranks are spawned processes that run the
port alone.
"""
from __future__ import annotations

import torch

from repro_torch.launch import specs
from repro_torch.launch.dryrun import trace_case
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import engine
from repro_torch.models.module import tree_map
from repro_torch.sharding.model_axis import gather_params, shard_params
from repro_torch.sharding.rules import fsdp_rules


def mesh_of(shape, names):
    """A `DeviceMesh` of `shape` over the initialized CPU world."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def trace_rank_main(rank: int, inputs_path: str, out_path: str) -> None:
    """One rank of a (data, model) world running its real case of the
    inputs' config and shape under `OpCosts` (`dryrun.trace_case`), the
    VEDS round cut to `n_slots` slots; the record's fields saved."""
    inp = torch.load(inputs_path, weights_only=False)
    specs.N_SLOTS = inp["n_slots"]
    mesh = make_host_mesh(inp["model"])
    res = trace_case(inp["cfg"], inp["shape"], mesh, "cpu", fake=False)
    res.pop("outputs")
    torch.save(res, out_path.format(rank=rank))


def _rows(x, n: int, i: int):
    """Block i of n of x's leading dim."""
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def fsdp_rank_main(rank: int, inputs_path: str, out_path: str) -> None:
    """One rank of a (2, 2) ("data", "model") world. For each FSDP run
    (a one-vehicle config, its parameters and batch): the VFL round with
    the `embed` dims split over the data axis and the batch split over it
    too, the round's result gathered whole; the prefill logits of this
    rank's rows; one decode step of this rank's rows from the given
    cache. For each dp run (a `dp`-profile config of V vehicles): the
    round with the vehicle's parameters replicated over the model axis
    and its batch split over it. For each dp decode run: greedy decode
    steps of this rank's rows under the `dp` profile (the parameters
    whole, each cache's sequence dim cut over the model axis), from the
    given cache."""
    from repro_torch.fl.vfl import make_vfl_round
    from repro_torch.sharding.fsdp import layout_axis
    inp = torch.load(inputs_path, weights_only=False)
    mesh = make_host_mesh(2)
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    res = {}
    for name, run in inp["fsdp"].items():
        cfg, tp = run["cfg"], run["tp"]
        decl = engine.model_decl(cfg, tp)
        rules = fsdp_rules()
        mine = shard_params(mesh, run["params"], decl, rules)
        batch = {k: _rows(x[0], 2, d)[None] for k, x in run["batch"].items()}
        round_fn = make_vfl_round(cfg, mesh, tp, lr=inp["lr"], layout="fsdp")
        out = round_fn(tree_map(lambda x: x[None], mine), batch,
                       inp["mask"], inp["weights"])
        whole = gather_params(mesh, tree_map(lambda x: x[0], out), decl,
                              rules)
        ax = layout_axis(mesh, "fsdp")
        with torch.no_grad():
            src = run.get("src")
            logits, _ = engine.forward(
                mine, _rows(run["tokens"], 2, d), cfg, tp=tp,
                src=None if src is None else _rows(src, 2, d),
                last_logit_only=True, seq_shard=True, mesh=ax)
            # the batch dim over the data axis, cache_seq over the model's
            cache = shard_params(mesh, run["cache"], run["cache_decl"])
            step_logits, _ = engine.decode_step(
                mine, cache, _rows(run["step_tokens"], 2, d), run["pos"],
                cfg, ax, tp=tp)
        res[name] = dict(whole=whole, prefill=logits, decode=step_logits)
    for name, run in inp["dp"].items():
        cfg, tp = run["cfg"], run["tp"]
        V = cfg.num_vehicles
        params_v = tree_map(lambda x: x[None], run["params"])
        batch = {k: _rows(x[d], 2, m)[None] for k, x in run["batch"].items()}
        round_fn = make_vfl_round(cfg, mesh, tp, lr=inp["lr"])
        out = round_fn(params_v, batch, inp["masks"][:V],
                       inp["weights_v"][:V])
        res[name] = dict(local=tree_map(lambda x: x[0], out), vehicle=d)
    for name, run in inp["dp_decode"].items():
        cfg = run["cfg"]
        cache = shard_params(mesh, run["cache"], run["cache_decl"],
                             specs.pick_rules(cfg, mesh))
        res[name] = dict(decode=greedy_decode(
            run, cache, _rows(run["tokens"], 2, d), layout_axis(mesh, "dp")))
    torch.save(res, out_path.format(rank=rank))


def greedy_decode(run, cache, tokens, mesh=None) -> torch.Tensor:
    """`run["steps"]` greedy `decode_step`s of `run["cfg"]` from `cache`
    at `run["pos"]`, each step's tokens the last one's argmax: the steps'
    logits [steps, B, V]."""
    pos, out = run["pos"], []
    with torch.no_grad():
        for _ in range(run["steps"]):
            logits, cache = engine.decode_step(run["params"], cache, tokens,
                                               pos, run["cfg"], mesh,
                                               tp=run["tp"])
            out.append(logits)
            tokens, pos = logits.argmax(-1), pos + 1
    return torch.stack(out)


def pod_rank_main(rank: int, inputs_path: str, out_path: str) -> None:
    """One rank of a (2, 2, 2) ("pod", "data", "model") world: the VFL
    round of 4 vehicles over (pod, data), each vehicle's model split over
    the model axis; the rank's vehicle gathered whole."""
    from repro_torch.fl.vfl import make_vfl_round
    inp = torch.load(inputs_path, weights_only=False)
    mesh = mesh_of((2, 2, 2), ("pod", "data", "model"))
    v = mesh.get_local_rank("pod") * 2 + mesh.get_local_rank("data")
    cfg, tp = inp["cfg"], inp["tp"]
    decl = engine.model_decl(cfg, tp)
    mine = tree_map(lambda x: x[None], shard_params(mesh, inp["params"],
                                                    decl))
    batch = {k: x[v:v + 1] for k, x in inp["batch_v"].items()}
    round_fn = make_vfl_round(cfg, mesh, tp, lr=inp["lr"])
    out = round_fn(mine, batch, inp["mask"], inp["weights"])
    whole = gather_params(mesh, tree_map(lambda x: x[0], out), decl)
    torch.save(dict(whole=whole, vehicle=v), out_path.format(rank=rank))
