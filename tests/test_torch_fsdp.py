"""The layouts of a vehicle's ranks that the dry run's cases need
(`sharding/fsdp.py`: `pick_layout`, `layout_axis`), on gloo worlds of CPU
processes (`tests/torch_dryrun_cases.py`, the ranks' side):

- FSDP for the one-vehicle configs (llama4-scout-17b-a16e and
  llama-3.2-vision-90b, the reference's `fsdp_rules`): on a (2, 2)
  ("data", "model") world the `embed` dims split over the data axis and
  gathered on use, the batch split over it, each model split over the
  model axis. The VFL round, gathered whole, against the port's one
  process within `ATOL` (`tests/test_torch_model_axis_vfl.py`'s 2e-4,
  scaled by a leaf's update where it passes 1) and against the
  reference's round (`make_vfl_round`, in this process) within `ATOL`
  for llama-3.2-vision, norm-wise within `MODEL_TOL` for llama4-scout
  (ill-conditioned at the reference's init); the prefill logits and one
  decode step of each rank's rows against one process within `ATOL`;
- vehicles over ("pod", "data") beside a model axis: one round of 4
  vehicles on a (2, 2, 2) world of 8 ranks against one process;
- the `dp` profile: parameters replicated over the model axis, each
  vehicle's batch split over it, on a (2, 2) world against one process;
  and its decode (each cache's sequence dim cut over the model axis, the
  batch's rows over the data axis, every head on every rank): greedy
  steps of a dense and a hybrid (zamba2) smoke config against one
  process's, logits within ATOL and argmax identical.

All at smoke widths in fp32, one round each.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dryrun_cases as DC
from repro.configs.registry import get_smoke_config as j_get_smoke_config
from repro.data.synthetic import lm_batch as j_lm_batch
from repro.fl.vfl import make_vfl_round as j_make_vfl_round
from repro.models import engine as jengine
from repro.models.module import materialize as j_materialize
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.synthetic import lm_batch
from repro_torch.fl import vfl
from repro_torch.launch.mesh import run_world
from repro_torch.models import engine
from repro_torch.models.module import materialize, tree_leaves, tree_map
from repro_torch.sharding.policy import attention_tp_mode
from torch_ref_vfl import MODEL_TOL

M, B, SEQ, LR, ATOL = 2, 4, 32, 0.1, 2e-4
F32 = dict(param_dtype="float32", compute_dtype="float32", grad_accum=1)
FSDP_ARCHS = ("llama4-scout-17b-a16e", "llama-3.2-vision-90b")
CACHE_S, POS = 64, 40
WORLD_TIMEOUT_S = 300


def _reference_round(arch, cfg, tp, batch, src):
    """The reference's round of one vehicle (its one-vehicle branch; the
    mesh carries no vehicle axis), on jax keys 0 (parameters)."""
    jcfg = j_get_smoke_config(arch).replace(**F32)
    jp = j_materialize(jax.random.key(0), jengine.model_decl(jcfg, tp))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jb = {k: jnp.asarray(v.numpy())[None] for k, v in batch.items()}
    if src is not None:
        jb["src"] = jnp.asarray(src.numpy())[None]
    with jax.set_mesh(mesh):
        out = jax.jit(j_make_vfl_round(jcfg, mesh, tp, lr=LR))(
            jax.tree.map(lambda x: x[None], jp), jb, jnp.ones((1,)),
            jnp.ones((1,)))
    return jp, [np.asarray(x)[0] for x in jax.tree.leaves(out)]


def _fsdp_run(arch):
    cfg = get_smoke_config(arch).replace(**F32)
    tp = attention_tp_mode(cfg.num_heads, M)
    rng = np.random.default_rng(3)
    b = j_lm_batch(jax.random.key(1), B, SEQ, cfg.vocab_size)
    batch = {k: torch.as_tensor(np.array(x), dtype=torch.int64)
             for k, x in b.items()}
    src = torch.as_tensor(rng.normal(0, 0.1, (B, cfg.num_src_tokens,
                                              cfg.src_dim)),
                          dtype=torch.float32) if cfg.src_dim else None
    jp, ref = _reference_round(arch, cfg, tp, batch, src)
    params = engine.llm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    cdecl = engine.cache_decl(cfg, B, CACHE_S)
    gen = torch.Generator().manual_seed(4)
    cache = tree_map(lambda d: 0.5 * torch.randn(d.shape, generator=gen),
                     cdecl)
    run = dict(cfg=cfg, tp=tp, params=params,
               batch={k: x[None] for k, x in batch.items()},
               tokens=batch["tokens"], cache=cache, cache_decl=cdecl,
               step_tokens=batch["tokens"][:, 0], pos=torch.tensor(POS))
    if src is not None:
        run["batch"]["src"] = src[None]
        run["src"] = src
    return run, ref


def _one_process_fsdp(run):
    cfg, tp, params = run["cfg"], run["tp"], run["params"]
    one = vfl.make_vfl_round(cfg, None, tp, lr=LR)(
        tree_map(lambda x: x[None], params), run["batch"],
        torch.ones(1), torch.ones(1))
    with torch.no_grad():
        logits, _ = engine.forward(params, run["tokens"], cfg, tp=tp,
                                   src=run.get("src"), last_logit_only=True,
                                   seq_shard=True)
        cache = tree_map(torch.clone, run["cache"])
        step, _ = engine.decode_step(params, cache, run["step_tokens"],
                                     run["pos"], cfg, None, tp=tp)
    return dict(whole=tree_map(lambda x: x[0], one), prefill=logits,
                decode=step)


def _dp_run():
    cfg = get_smoke_config("qwen3-32b").replace(
        **F32, num_vehicles=2, sharding_profile="dp")
    tp = attention_tp_mode(cfg.num_heads, 1)
    params = materialize(torch.Generator().manual_seed(7),
                         engine.model_decl(cfg, tp))
    batch = lm_batch(torch.Generator().manual_seed(8), 2 * B, SEQ,
                     cfg.vocab_size)
    return dict(cfg=cfg, tp=tp, params=params,
                batch={k: x.reshape(2, B, SEQ) for k, x in batch.items()})


DP_DECODE_ARCHS, DP_DECODE_STEPS = ("qwen3-32b", "zamba2-2.7b"), 4


def _dp_decode_run(arch):
    """A `dp`-profile smoke config's parameters, a cache of CACHE_S slots
    filled at random and a batch of B rows at position POS (the new rows
    go to the second model rank's slots), for DP_DECODE_STEPS greedy
    steps."""
    cfg = get_smoke_config(arch).replace(**F32, sharding_profile="dp")
    tp = attention_tp_mode(cfg.num_heads, M)
    params = materialize(torch.Generator().manual_seed(11),
                         engine.model_decl(cfg, tp))
    cdecl = engine.cache_decl(cfg, B, CACHE_S)
    gen = torch.Generator().manual_seed(12)
    cache = tree_map(lambda d: 0.5 * torch.randn(d.shape, generator=gen),
                     cdecl)
    tokens = torch.randint(0, cfg.vocab_size, (B,), generator=gen)
    return dict(cfg=cfg, tp=tp, params=params, cache=cache, cache_decl=cdecl,
                tokens=tokens, pos=torch.tensor(POS), steps=DP_DECODE_STEPS)


MASKS = torch.tensor([1.0, 1.0]), torch.tensor([1.0, 2.0])


@pytest.fixture(scope="module")
def fsdp_world(tmp_path_factory):
    """The FSDP runs, the dp run and the dp decode runs on a (2, 2) world,
    every rank's results; the one-process results; the reference's
    rounds."""
    tmp = tmp_path_factory.mktemp("fsdp")
    runs, refs = {}, {}
    for arch in FSDP_ARCHS:
        runs[arch], refs[arch] = _fsdp_run(arch)
    dp = {"qwen3-32b-dp": _dp_run()}
    dp_decode = {f"{a}-dp-decode": _dp_decode_run(a) for a in DP_DECODE_ARCHS}
    path, out = str(tmp / "inputs.pt"), str(tmp / "out{rank}.pt")
    torch.save(dict(fsdp=runs, dp=dp, dp_decode=dp_decode, lr=LR,
                    mask=torch.ones(1), weights=torch.ones(1),
                    masks=MASKS[0], weights_v=MASKS[1]), path)
    run_world(DC.fsdp_rank_main, 4, path, out, device="cpu", threads=1,
              timeout_s=WORLD_TIMEOUT_S, store_dir=str(tmp))
    ranks = [torch.load(out.format(rank=r), weights_only=False)
             for r in range(4)]
    one = {a: _one_process_fsdp(runs[a]) for a in FSDP_ARCHS}
    d = dp["qwen3-32b-dp"]
    stacked = tree_map(lambda x: x.unsqueeze(0).expand(2, *x.shape),
                       d["params"])
    one["qwen3-32b-dp"] = vfl.make_vfl_round(d["cfg"], None, d["tp"],
                                             lr=LR)(stacked, d["batch"],
                                                    *MASKS)
    for name, run in dp_decode.items():
        one[name] = DC.greedy_decode(run, tree_map(torch.clone, run["cache"]),
                                     run["tokens"])
    return runs, refs, ranks, one


def _scaled_atol(update) -> float:
    """ATOL, times the leaf's largest update where it passes 1: the fp32
    sums behind an update of that size round at its scale."""
    return ATOL * max(1.0, float(update.abs().max()))


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_fsdp_round_matches_one_process_and_the_reference(fsdp_world,
                                                          arch):
    """Every rank's round, gathered whole over both axes, against the
    port's one-process round within `_scaled_atol`, and against the
    reference's: llama-3.2-vision within ATOL; llama4-scout, which has
    no qk-norm and is ill-conditioned at the reference's init (its
    embedding table moves by 26 in this round, and the port's one
    process lands 1.2e-2 from the reference there), each leaf's update
    within `MODEL_TOL` of its norm, the repo's bound for it
    (`tests/torch_ref_vfl.py`). The update is not zero."""
    runs, refs, ranks, one = fsdp_world
    params = tree_leaves(runs[arch]["params"])
    for r in range(4):
        ours = tree_leaves(ranks[r][arch]["whole"])
        assert len(ours) == len(refs[arch]) == len(params)
        for a, b, c, p in zip(ours, tree_leaves(one[arch]["whole"]),
                              refs[arch], params):
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       atol=_scaled_atol(b - p), rtol=0)
            if arch == "llama4-scout-17b-a16e":
                ref_step = c - p.numpy()
                assert np.linalg.norm(a.numpy() - c) <= MODEL_TOL * max(
                    np.linalg.norm(ref_step), 1e-30)
            else:
                np.testing.assert_allclose(a.numpy(), c, atol=ATOL, rtol=0)
        assert any(not torch.equal(a, p) for a, p in zip(ours, params))


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_fsdp_prefill_and_decode_match_one_process(fsdp_world, arch):
    """Each rank's prefill logits and decode-step logits (its rows of the
    batch; weights gathered with no gradient) against one process's rows,
    within ATOL."""
    _, _, ranks, one = fsdp_world
    for r in range(4):
        d = r // M
        for key in ("prefill", "decode"):
            whole = one[arch][key]
            rows = whole[d * (B // 2):(d + 1) * (B // 2)]
            np.testing.assert_allclose(ranks[r][arch][key].numpy(),
                                       rows.numpy(), atol=ATOL, rtol=0)


def test_dp_profile_round_matches_one_process(fsdp_world):
    """The dp profile: each vehicle's parameters replicated over the
    model axis and its batch split over it (gradients all-reduced over
    it), against one process, within ATOL, on every rank."""
    runs, _, ranks, one = fsdp_world
    ref = one["qwen3-32b-dp"]
    for r in range(4):
        got = ranks[r]["qwen3-32b-dp"]
        for a, b in zip(tree_leaves(got["local"]), tree_leaves(ref)):
            np.testing.assert_allclose(a.numpy(), b[got["vehicle"]].numpy(),
                                       atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", DP_DECODE_ARCHS)
def test_dp_profile_decode_matches_one_process(fsdp_world, arch):
    """The dp profile's decode: each rank's greedy steps (its rows of the
    batch over the data axis, every head, S/2 of the cache's slots, the
    partial softmax statistics merged over the model axis) against one
    process's rows, within ATOL, the argmax identical at every step."""
    _, _, ranks, one = fsdp_world
    whole = one[f"{arch}-dp-decode"]
    for r in range(4):
        d = r // M
        got = ranks[r][f"{arch}-dp-decode"]["decode"]
        rows = whole[:, d * (B // 2):(d + 1) * (B // 2)]
        np.testing.assert_allclose(got.numpy(), rows.numpy(), atol=ATOL,
                                   rtol=0)
        assert torch.equal(got.argmax(-1), rows.argmax(-1))


def test_vehicles_over_pod_and_data_beside_a_model_axis(tmp_path):
    """4 vehicles over ("pod", "data") of a (2, 2, 2) world, each model
    split over the model axis, aggregated over the flattened group of the
    ranks sharing a model coordinate: every rank's vehicle, gathered
    whole, against the one-process round within ATOL."""
    cfg = get_smoke_config("qwen3-32b").replace(**F32, num_vehicles=4)
    tp = attention_tp_mode(cfg.num_heads, M)
    params = materialize(torch.Generator().manual_seed(9),
                         engine.model_decl(cfg, tp))
    b = lm_batch(torch.Generator().manual_seed(10), 4 * 2, SEQ,
                 cfg.vocab_size)
    batch_v = {k: x.reshape(4, 2, SEQ) for k, x in b.items()}
    mask, weights = torch.tensor([1., 0., 1., 1.]), torch.tensor(
        [1., 2., 1., 3.])
    path, out = str(tmp_path / "inputs.pt"), str(tmp_path / "out{rank}.pt")
    torch.save(dict(cfg=cfg, tp=tp, params=params, batch_v=batch_v, lr=LR,
                    mask=mask, weights=weights), path)
    run_world(DC.pod_rank_main, 8, path, out, device="cpu", threads=1,
              timeout_s=WORLD_TIMEOUT_S, store_dir=str(tmp_path))
    stacked = tree_map(lambda x: x.unsqueeze(0).expand(4, *x.shape), params)
    one = vfl.make_vfl_round(cfg, None, tp, lr=LR)(stacked, batch_v, mask,
                                                   weights)
    seen = set()
    for r in range(8):
        got = torch.load(out.format(rank=r), weights_only=False)
        seen.add(got["vehicle"])
        for a, c in zip(tree_leaves(got["whole"]), tree_leaves(one)):
            np.testing.assert_allclose(a.numpy(), c[got["vehicle"]].numpy(),
                                       atol=ATOL, rtol=0)
    assert seen == {0, 1, 2, 3}
