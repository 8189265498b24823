"""The largest SOV virtual queue under `stream_rounds` at fig10's
setting, the reference's against the port's, on the CPU:

    PYTHONPATH=src python tests/torch_queue_growth.py [seed ...]

The setting is `chip_smoke.py phase_stream_compare`'s queue check: S = U
= 10, T = 60, a persistent fleet of 40, carried queues, 10 rounds under
`sa` and `v2i_only`, `VedsParams(Q=1e7, slot=0.1, ipm_warm_iters=10)`,
`v_max` 10. The two sides draw their scenarios from different generators
(`jax.random` against `torch.Generator`), so each seed gives each side
its own fleet: compare the ranges over the seeds, not seed by seed.
Prints, per side, scheduler and seed, the largest queue after each round.
"""
import sys

import jax
import numpy as np

from repro.channel.mobility import ManhattanParams as JManhattan
from repro.channel.v2x import ChannelParams as JChannel
from repro.core.baselines import get_scheduler as j_get_scheduler
from repro.core.lyapunov import VedsParams as JVeds
from repro.core.scenario import ScenarioParams as JScenario
from repro.core.streaming import StreamConfig as JStreamConfig
from repro.core.streaming import stream_rounds as j_stream_rounds
from repro_torch.channel.mobility import ManhattanParams
from repro_torch.channel.v2x import ChannelParams
from repro_torch.core.baselines import get_scheduler
from repro_torch.core.lyapunov import VedsParams
from repro_torch.core.scenario import ScenarioParams
from repro_torch.core.streaming import StreamConfig, stream_rounds

SETTING = dict(prm=dict(alpha=2.0, V=0.2, Q=1e7, slot=0.1,
                        ipm_warm_iters=10),
               sc=dict(n_sov=10, n_opv=10, n_slots=60, batch_size=32),
               cfg=dict(n_rounds=10, batch=1, carry_queues=True,
                        n_fleet=40),
               v_max=10.0)


def reference(seed: int, name: str) -> np.ndarray:
    res = j_stream_rounds(
        jax.random.key(seed), j_get_scheduler(name),
        JScenario(**SETTING["sc"]), JManhattan(v_max=SETTING["v_max"]),
        JChannel(), JVeds(**SETTING["prm"]), JStreamConfig(**SETTING["cfg"]))
    return np.asarray(res.outputs.carry.qs).max(axis=(1, 2))


def port(seed: int, name: str) -> np.ndarray:
    res = stream_rounds(
        seed, get_scheduler(name), ScenarioParams(**SETTING["sc"]),
        ManhattanParams(v_max=SETTING["v_max"]), ChannelParams(),
        VedsParams(**SETTING["prm"]), StreamConfig(**SETTING["cfg"]),
        device="cpu")
    return res.outputs.carry.qs.amax(dim=(1, 2)).numpy()


def main(argv=None) -> int:
    seeds = [int(s) for s in (sys.argv[1:] if argv is None else argv)] \
        or [11, 0, 1, 2]
    for side, fn in (("reference", reference), ("port", port)):
        for name in ("sa", "v2i_only"):
            for seed in seeds:
                q = fn(seed, name)
                print(f"{side} {name} seed {seed}: largest SOV queue by "
                      f"round {[f'{x:.3e}' for x in q]} J", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
