"""The model-axis cases that `test_torch_model_axis.py` runs on every rank
of a spawned gloo world, on a (1, n) ("data", "model") mesh.

This module imports torch and the port only (the ranks are spawned
processes and import no jax). The inputs are one dict of cases saved
with `torch.save`, each holding whole tensors (parameters from the
reference's init, inputs from numpy draws); every rank cuts its block
(`shard_params`, or the cache's sequence block), runs the case, and
returns whole results: outputs as every rank holds them, gradients of
split leaves gathered (`gather_params`), caches all-gathered.
"""
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import attention as att
from repro_torch.models import blocks as B
from repro_torch.models import engine
from repro_torch.models import layers as L
from repro_torch.models.module import tree_leaves, tree_unflatten
from repro_torch.sharding.model_axis import (gather_from, gather_params,
                                             model_axis, shard_params)

APPLY = {"attn": B.attn_apply, "mlp": B.mlp_apply, "moe": B.moe_apply,
         "mamba": B.mamba_apply, "mlstm": B.mlstm_apply,
         "slstm": B.slstm_apply}
DECODE = {"mamba": B.mamba_decode, "mlstm": B.mlstm_decode,
          "slstm": B.slstm_decode}


def _with_grad(tree):
    leaves = [x.detach().clone().requires_grad_() for x in tree_leaves(tree)]
    return leaves, tree_unflatten(tree, leaves)


def _grads(mesh, p_loc, decl, grads):
    return gather_params(mesh, tree_unflatten(p_loc, list(grads)), decl)


def block(mesh, c):
    """A sub-block's forward (x + f(x), and MoE's aux) and the gradients
    of sum(out * ct) (+ aux) for its parameters and inputs."""
    p_loc = shard_params(mesh, c["params"], c["decl"])
    leaves, p = _with_grad(p_loc)
    kw = dict(c["kw"])
    ins = [c["x"].clone().requires_grad_()]
    if "src" in c:
        ins.append(c["src"].clone().requires_grad_())
        kw["src"] = ins[-1]
    out = APPLY[c["fn"]](p, ins[0], c["cfg"], mesh=mesh, **kw)
    aux = None
    if isinstance(out, tuple):
        out, aux = out
    loss = (out * c["ct"]).sum() + (0.0 if aux is None else aux)
    g = torch.autograd.grad(loss, leaves + ins)
    whole = gather_params(mesh, p_loc, c["decl"])
    return dict(out=out.detach(), aux=None if aux is None else aux.detach(),
                gathered_equal=all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(whole), tree_leaves(c["params"]))),
                grads=_grads(mesh, p_loc, c["decl"], g[:len(leaves)]),
                local_grads=list(g[:len(leaves)]),
                dins=list(g[len(leaves):]))


def block_decode(mesh, c):
    """A recurrent sub-block's decode steps over `c["xs"]` [steps, B, d]
    from a zero cache (this rank's block of it, `shard_params` under the
    cache's declaration): each step's output, and the cache after the
    last step as this rank holds it ([1, ...] leaves)."""
    p = shard_params(mesh, c["params"], c["decl"])
    cache = shard_params(mesh, c["cache"], c["cache_decl"])
    slot = {k: v[0] for k, v in cache.items()}
    outs = []
    with torch.no_grad():
        for t, x in enumerate(c["xs"]):
            y, slot = DECODE[c["fn"]](p, x, slot, torch.tensor(t), c["cfg"],
                                      mesh)
            outs.append(y)
    return dict(outs=torch.stack(outs),
                cache={k: v[None].clone() for k, v in slot.items()})


def lm(mesh, c):
    """The vocab-parallel embedding, LM head (untied and tied) and loss:
    the two losses, their logits gathered, the gradients."""
    p_loc = shard_params(mesh, c["params"], c["decl"])
    leaves, p = _with_grad(p_loc)
    x = L.embed(p["embed"], c["tokens"], mesh=mesh) * c["scale"]
    logits = L.unembed(p["lm_head"], x, mesh=mesh)
    tied = L.unembed_tied(p["embed"], x, mesh=mesh)
    losses = [L.softmax_cross_entropy(lg, c["labels"], mesh=mesh)
              for lg in (logits, tied)]
    g = torch.autograd.grad(losses[0] + 2.0 * losses[1], leaves)
    return dict(losses=[x.detach() for x in losses],
                logits=L.gather_logits(logits.detach(), mesh),
                tied=L.gather_logits(tied.detach(), mesh),
                x=x.detach(), grads=_grads(mesh, p_loc, c["decl"], g))


def seq_flash(mesh, c):
    """`seq_sharded_flash_attention` and its gradients."""
    q, k, v = (c[n].clone().requires_grad_() for n in ("q", "k", "v"))
    out = att.seq_sharded_flash_attention(q, k, v, q_chunk=c["q_chunk"],
                                          mesh=mesh, **c["kw"])
    g = torch.autograd.grad((out * c["ct"]).sum(), (q, k, v))
    return dict(out=out.detach(), grads=list(g))


def _seq_block(x, mesh):
    ax = model_axis(mesh)
    return x.narrow(1, *ax.block(x.shape[1])).clone()


def decode(mesh, c):
    """`decode_attention` (or `decode_cross_attention`) over this rank's
    block of the cache at each position of `c["pos"]` in turn; the
    outputs and the whole caches after each step."""
    ck, cv = _seq_block(c["ck"], mesh), _seq_block(c["cv"], mesh)
    res = []
    for i, pos in enumerate(c["pos"]):
        if c["cross"]:
            out = att.decode_cross_attention(mesh, c["q"][i], ck, cv)
        else:
            out, ck, cv = att.decode_attention(
                mesh, c["q"][i], ck, cv, c["kn"][i], c["vn"][i],
                torch.tensor(pos, device=ck.device), window=c["window"])
        res.append((out, gather_from(ck, model_axis(mesh), 1).clone(),
                    gather_from(cv, model_axis(mesh), 1).clone()))
    return res


def model(mesh, c):
    """`engine.forward`'s logits, then `decode_step` over the first
    tokens from a zero cache of this rank's slots (whisper and vlm from
    `build_cross_cache`)."""
    cfg, tp = c["cfg"], c["tp"]
    decl = engine.model_decl(cfg, tp)
    params = shard_params(mesh, c["params"], decl)
    gathered_equal = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(gather_params(mesh, params, decl)),
        tree_leaves(c["params"])))
    with torch.no_grad():
        logits, aux = engine.forward(params, c["tokens"], cfg, tp=tp,
                                     src=c["src"], mesh=mesh)
        dev = c["tokens"].device
        cache = engine.zero_cache(engine.cache_decl(
            cfg, c["tokens"].shape[0], c["cache_len"]), dev, mesh=mesh)
        if c["src"] is not None:
            cache = engine.build_cross_cache(cfg, params, cache, c["src"],
                                             tp, mesh=mesh)
        steps = []
        for t in range(c["steps"]):
            lg, cache = engine.decode_step(params, cache, c["tokens"][:, t],
                                           torch.tensor(t, device=dev), cfg,
                                           mesh, tp=tp)
            steps.append(lg)
    return dict(logits=logits, aux=aux, decode=torch.stack(steps, 1),
                gathered_equal=gathered_equal,
                cache_shapes=[tuple(x.shape) for x in tree_leaves(cache)])


KINDS = {"block": block, "block_decode": block_decode, "lm": lm,
         "seq_flash": seq_flash, "decode": decode, "model": model}


def rank_main(rank: int, inputs_path: str, out_path: str) -> None:
    """Every case of the inputs on a (1, world) mesh; the results saved
    to `out_path` formatted with the rank."""
    cases = torch.load(inputs_path, weights_only=False)
    mesh = make_host_mesh(dist.get_world_size())
    torch.save({name: KINDS[c["kind"]](mesh, c) for name, c in cases.items()},
               out_path.format(rank=rank))


def vfl_rank_main(rank: int, inputs_path: str, out_path: str) -> None:
    """The VFL round on a (V, M) ("data", "model") mesh, for each run of
    the inputs (a configuration, its parameters and batches): this
    rank's block of its vehicle's model, for every (mask, weights) of
    the run; each result as this rank holds it and gathered whole over
    the model axis, saved to `out_path` formatted with the rank (one
    list a run)."""
    from repro_torch.fl.vfl import make_vfl_round
    from repro_torch.models.module import tree_map
    inp = torch.load(inputs_path, weights_only=False)
    mesh = make_host_mesh(inp["model"])
    v = mesh.get_local_rank("data")
    res = {}
    for name, run in inp["runs"].items():
        cfg, tp = run["cfg"], run["tp"]
        decl = engine.model_decl(cfg, tp)
        mine = tree_map(lambda x: x[None], shard_params(mesh, run["params"],
                                                        decl))
        batch = {k: x[v:v + 1] for k, x in run["batch_v"].items()}
        round_fn = make_vfl_round(cfg, mesh, tp, lr=inp["lr"])
        out = []
        for m, w in inp["cases"]:
            local = tree_map(lambda x: x[0], round_fn(mine, batch, m, w))
            out.append(dict(local=local,
                            whole=gather_params(mesh, local, decl)))
        res[name] = out
    torch.save(res, out_path.format(rank=rank))
