"""One VFL round of an architecture's smoke config, the port's against
the reference's, for the model-zoo tests (`tests/test_torch_moe.py`,
`tests/test_torch_zoo.py`). Imports jax: not for the card's tests.

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


def vfl_round_against_reference(arch, seed):
    """One `make_vfl_round` of `arch`'s smoke config (fp32, V = 4, 2 x 128
    tokens a vehicle, mask [1, 0, 1, 1], weights [1, 1, 2, 1]) from the
    reference's init, against per-vehicle local SGD of the reference and
    the masked weighted mean. Returns each leaf's update error (the
    aggregate less the old parameters), norm-wise."""
    kw = dict(F32, num_vehicles=V, grad_accum=1)
    jcfg = j_get_smoke_config(arch).replace(**kw)
    cfg = get_smoke_config(arch).replace(**kw)
    jp = j_materialize(jax.random.key(seed), jengine.model_decl(jcfg,
                                                                "head"))
    batch = j_lm_batch(jax.random.key(1), V * BPV, SEQ, jcfg.vocab_size)
    bv = jax.tree.map(lambda x: x.reshape(V, BPV, *x.shape[1:]), batch)
    mask, weights = np.array([1., 0., 1., 1.]), np.array([1., 1., 2., 1.])
    sgd = jax.jit(lambda p, b: j_local_sgd(p, b, jcfg, "head", j_lm_loss,
                                           LR))
    locals_ = [sgd(jp, jax.tree.map(lambda x: x[v], bv)) for v in range(V)]
    w = mask * weights
    ref = jax.tree.map(lambda *xs: sum(float(wi) * x for wi, x in
                                       zip(w, xs)) / float(w.sum()),
                       *locals_)
    out = vfl.make_vfl_round(cfg, None, "head", lr=LR)(
        tree_map(lambda x: x.unsqueeze(0).expand(V, *x.shape),
                 engine.llm_params_from_jax(jax.tree.map(np.asarray, jp),
                                            "cpu")),
        {k: tt(np.asarray(x)).long() for k, x in bv.items()},
        tt(mask.astype(np.float32)), tt(weights.astype(np.float32)))
    errs = []
    for a, b, p0 in zip(tree_leaves(out), jax.tree.leaves(ref),
                        jax.tree.leaves(jp)):
        assert a.shape[0] == V and a.stride(0) == 0
        p0 = np.asarray(p0)
        assert np.isfinite(tn(a[0])).all()
        errs.append(_normwise(tn(a[0]) - p0, np.asarray(b) - p0))
    return errs
