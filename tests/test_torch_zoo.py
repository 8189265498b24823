"""The dense configurations this slice registers, `starcoder2-15b`
(gelu-tanh, non-gated MLP, GQA 8/2 of 32), `codeqwen1.5-7b` (silu,
gated, 4 heads of 64 with as many KV heads) and `minitron-4b` (relu,
non-gated, GQA 4/2 of 64), against the reference at their smoke configs
in fp32 with one torch intra-op thread. On one device their TP mode is
"head" (`sharding/policy.py`), so they need no block beyond qwen3's.

Weights are the reference's own init, carried over with
`llm_params_from_jax`. None of the three has qk-norm, so the whole model
is ill-conditioned at that init, as granite's is: logits and each leaf's
VFL update are held within `MODEL_TOL` (`tests/torch_ref_vfl.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import get_smoke_config as j_get_smoke_config
from repro.models import engine as jengine
from repro.models.module import Declared as JDeclared
from repro.models.module import materialize as j_materialize
from repro.models.module import param_count as j_param_count
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.models import engine
from repro_torch.models.module import param_count, tree_leaves
from torch_port_util import tn, tt
from torch_ref_vfl import MODEL_TOL, vfl_round_against_reference

DENSE = ("starcoder2-15b", "codeqwen1.5-7b", "minitron-4b")
F32 = dict(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so that parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decl_summary(tree, is_port):
    if is_port:
        return [(d.shape, d.axes, d.init, d.scale, str(d.dtype).split(".")[-1])
                for d in tree_leaves(tree)]
    return [(d.shape, d.axes, d.init, d.scale, str(d.dtype))
            for d in jax.tree.leaves(tree, is_leaf=lambda x:
                                     isinstance(x, JDeclared))]


@pytest.mark.parametrize("arch", DENSE)
def test_dense_model_decl_matches_reference_at_full_width(arch):
    """The same leaves in the same order at full width, cut to 2
    repetitions (11 leaves without a gate, 12 with one)."""
    jcfg = j_get_config(arch).replace(n_rep=2)
    cfg = get_config(arch).replace(n_rep=2)
    jd, d = jengine.model_decl(jcfg, "head"), engine.model_decl(cfg, "head")
    assert _decl_summary(d, True) == _decl_summary(jd, False)
    assert param_count(d) == j_param_count(jd)
    assert len(tree_leaves(d)) == 11 + (cfg.act == "silu")


@pytest.mark.parametrize("arch", DENSE)
def test_dense_forward_logits_match_reference(arch):
    jcfg = j_get_smoke_config(arch).replace(**F32)
    cfg = get_smoke_config(arch).replace(**F32)
    jp = j_materialize(jax.random.key(3), jengine.model_decl(jcfg, "head"))
    toks = np.random.default_rng(26).integers(0, jcfg.vocab_size, (2, 128))
    ref, _ = jengine.forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                             tp="head")
    logits, aux = engine.forward(
        engine.llm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
        tt(toks), cfg, tp="head")
    assert float(aux) == 0.0
    np.testing.assert_allclose(tn(logits), np.asarray(ref), atol=MODEL_TOL,
                               rtol=0)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_vfl_round_matches_reference(arch):
    """One VFL round of the smoke config: each leaf's update within
    MODEL_TOL of its norm."""
    errs = vfl_round_against_reference(arch, 3)
    assert len(errs) == 11 + (get_smoke_config(arch).act == "silu")
    assert max(errs) <= MODEL_TOL, errs
