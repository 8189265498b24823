"""One VFL round of an architecture's smoke config, the port's against
the reference's, for the model-zoo tests (`tests/test_torch_moe.py`,
`tests/test_torch_zoo.py`, `tests/test_torch_xlstm.py`,
`tests/test_torch_encdec.py`). Imports jax: not for the card's tests.

The configurations without qk-norm are ill-conditioned at the
reference's init (`tests/test_torch_moe.py`'s docstring measures it):
with every parameter moved by half an ulp, the reference's own logits
move by up to 1.3e-2 and its VFL update by up to 1.04e-2 of a leaf's
norm across granite-moe-1b-a400m, llama4-scout-17b-a16e,
starcoder2-15b, codeqwen1.5-7b and minitron-4b (two seeds each), and
the port lands up to 6.0e-3 and 6.7e-3 from it. MODEL_TOL, about twice
the reference's own worst move, holds the port on both.
"""
import jax
import numpy as np

from repro.configs.registry import get_smoke_config as j_get_smoke_config
from repro.data.synthetic import lm_batch as j_lm_batch
from repro.fl.vfl import _local_sgd as j_local_sgd
from repro.fl.vfl import lm_loss as j_lm_loss
from repro.models import engine as jengine
from repro.models.module import materialize as j_materialize
from repro_torch.configs.registry import get_smoke_config
from repro_torch.fl import vfl
from repro_torch.models import engine
from repro_torch.models.module import tree_leaves, tree_map
from torch_port_util import tn, tt

MODEL_TOL = 2e-2
F32 = dict(param_dtype="float32", compute_dtype="float32")
V, BPV, SEQ, LR = 4, 2, 128, 0.1


def _normwise(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def src_batch(cfg, b, seed):
    """The frame (audio) or patch (vlm) embeddings of a batch of b rows,
    0.1 * N(0, 1) [b, num_src_tokens, src_dim] in fp32, as
    `tests/test_arch_smoke.py` draws them."""
    return 0.1 * np.random.default_rng(seed).normal(
        size=(b, cfg.num_src_tokens, cfg.src_dim)).astype(np.float32)


def half_ulp(tree, seed):
    """The tree with every leaf moved by half an ulp, x (1 +- 6e-8) with
    random signs drawn from numpy's generator `seed`."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: x * (1 + 6e-8 * rng.choice(
        [-1.0, 1.0], size=x.shape).astype(np.float32)), tree)


def _round(arch, seed, replace):
    """The reference's smoke config of `arch` (with `replace`), its init,
    the batch, the mask and the weights of the round, and the reference's
    round (per-vehicle local SGD, then the masked weighted mean) as a
    function of the weights, returning the aggregate's leaves."""
    kw = dict(F32, num_vehicles=V, grad_accum=1, **replace)
    jcfg = j_get_smoke_config(arch).replace(**kw)
    jp = j_materialize(jax.random.key(seed), jengine.model_decl(jcfg,
                                                                "head"))
    batch = j_lm_batch(jax.random.key(1), V * BPV, SEQ, jcfg.vocab_size)
    if jcfg.family in ("vlm", "audio"):
        batch["src"] = src_batch(jcfg, V * BPV, 2)
    bv = jax.tree.map(lambda x: x.reshape(V, BPV, *x.shape[1:]), batch)
    mask, weights = np.array([1., 0., 1., 1.]), np.array([1., 1., 2., 1.])
    sgd = jax.jit(lambda p, b: j_local_sgd(p, b, jcfg, "head", j_lm_loss,
                                           LR))
    w = mask * weights

    def ref_round(p):
        locals_ = [sgd(p, jax.tree.map(lambda x: x[v], bv))
                   for v in range(V)]
        return [np.asarray(x) for x in jax.tree.leaves(jax.tree.map(
            lambda *xs: sum(float(wi) * x for wi, x in zip(w, xs))
            / float(w.sum()), *locals_))]
    return jp, bv, mask, weights, ref_round


def vfl_round_against_reference(arch, seed, **replace):
    """One `make_vfl_round` of `arch`'s smoke config (fp32, V = 4, 2 x 128
    tokens a vehicle, and `src` for the audio and vlm families
    (`src_batch`), mask [1, 0, 1, 1], weights [1, 1, 2, 1]; `replace`
    cuts the config, e.g. its depth) from the reference's init, against
    per-vehicle local SGD of the reference and the masked weighted mean.
    Returns each leaf's update error (the aggregate less the old
    parameters), norm-wise."""
    jp, bv, mask, weights, ref_round = _round(arch, seed, replace)
    cfg = get_smoke_config(arch).replace(
        **F32, num_vehicles=V, grad_accum=1, **replace)
    ref = ref_round(jp)
    out = vfl.make_vfl_round(cfg, None, "head", lr=LR)(
        tree_map(lambda x: x.unsqueeze(0).expand(V, *x.shape),
                 engine.llm_params_from_jax(jax.tree.map(np.asarray, jp),
                                            "cpu")),
        {k: tt(np.asarray(x)) if k == "src" else tt(np.asarray(x)).long()
         for k, x in bv.items()},
        tt(mask.astype(np.float32)), tt(weights.astype(np.float32)))
    errs = []
    for a, b, p0 in zip(tree_leaves(out), ref, jax.tree.leaves(jp)):
        assert a.shape[0] == V and a.stride(0) == 0
        p0 = np.asarray(p0)
        assert np.isfinite(tn(a[0])).all()
        errs.append(_normwise(tn(a[0]) - p0, b - p0))
    return errs


def reference_half_ulp_move(arch, seed, draws, **replace):
    """The reference's own move of the round in
    `vfl_round_against_reference`: the largest, over leaves and over
    `draws` half-ulp draws of every weight (`half_ulp`, seeds 0 ..
    draws - 1), of the change of a leaf's update, norm-wise. It says how
    far the reference itself is from its own answer at that config."""
    jp, _, _, _, ref_round = _round(arch, seed, replace)
    old = [np.asarray(p0) for p0 in jax.tree.leaves(jp)]
    ref = ref_round(jp)
    return max(_normwise(b2 - p0, b - p0)
               for d in range(draws)
               for b2, b, p0 in zip(ref_round(half_ulp(jp, d)), ref, old))
