"""The largest gradient entry of the LM loss at the reference's init, by
depth, the reference's against the port's, on the CPU in fp32:

    PYTHONPATH=src python tests/torch_grad_growth.py \\
        granite-moe-1b-a400m 1 2 3

`arch` at its full width with `n_rep` repetitions (the numbers after
it), the reference's own init (`materialize` with key 0) carried over
with `llm_params_from_jax`, one sequence of 64 tokens. Without qk-norm,
and with the `scaled` init's fan_in = shape[-2] (ROADMAP queue 3), the
gradients grow by an order of magnitude a repetition on both sides;
this is what sets the lr of a full-depth run on the card (PERF.md
section 4). Full width at a few repetitions takes a few GB of memory.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_config as j_get_config
from repro.fl.vfl import lm_loss as j_lm_loss
from repro.models import engine as jengine
from repro.models.module import materialize as j_materialize
from repro_torch.configs.registry import get_config
from repro_torch.fl import vfl
from repro_torch.models import engine
from repro_torch.models.module import tree_leaves, tree_unflatten

F32 = dict(param_dtype="float32", compute_dtype="float32")


def largest_gradients(arch: str, n_rep: int, seq: int = 64):
    """(reference, port): the largest |gradient| entry over all leaves."""
    jcfg = j_get_config(arch).replace(n_rep=n_rep, **F32)
    cfg = get_config(arch).replace(n_rep=n_rep, **F32)
    jp = j_materialize(jax.random.key(0), jengine.model_decl(jcfg, "head"))
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (1, seq))
    labels = np.roll(toks, -1, axis=1)
    ref = jax.grad(lambda p: j_lm_loss(
        p, {"tokens": jnp.asarray(toks, jnp.int32),
            "labels": jnp.asarray(labels, jnp.int32)}, jcfg, "head"))(jp)
    ref_max = max(float(np.abs(np.asarray(x)).max())
                  for x in jax.tree.leaves(ref))
    params = engine.llm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    del jp, ref
    leaves = [x.clone().requires_grad_() for x in tree_leaves(params)]
    loss = vfl.lm_loss(tree_unflatten(params, leaves),
                       {"tokens": torch.tensor(toks),
                        "labels": torch.tensor(labels)}, cfg, "head")
    port_max = max(float(g.abs().max())
                   for g in torch.autograd.grad(loss, leaves))
    return ref_max, port_max


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    arch, reps = argv[0], [int(r) for r in argv[1:]] or [1, 2, 3]
    for n in reps:
        ref, port = largest_gradients(arch, n)
        print(f"{arch} n_rep {n}: largest |gradient| reference {ref:.4e}, "
              f"port {port:.4e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
