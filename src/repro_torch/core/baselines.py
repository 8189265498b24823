"""Scheduler registry of the port.

Port of the `VedsScheduler` and `get_scheduler` parts of
`repro/core/baselines.py`. Only VEDS (Algorithm 2) is ported so far; the
four Section VI benchmarks (optimal, v2i_only, madca, sa) come with a
later slice of the port, and asking for one raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.channel.v2x import ChannelParams
from repro_torch.core import lyapunov as lyp
from repro_torch.core.scheduler import RoundOutputs, SchedulerCarry
from repro_torch.core.veds import RoundInputs, veds_round

# the reference's other schedulers, still to be ported
NOT_PORTED = ("optimal", "v2i_only", "madca", "sa")


@dataclasses.dataclass(frozen=True)
class VedsScheduler:
    """Algorithm 2, optionally without V2V cooperation."""
    name: str = "veds"
    enable_cot: bool = True

    def solve_round(self, rnd: RoundInputs, prm: lyp.VedsParams,
                    ch: ChannelParams,
                    carry: Optional[SchedulerCarry] = None) -> RoundOutputs:
        return veds_round(rnd, prm, ch, enable_cot=self.enable_cot,
                          carry=carry)

    def __call__(self, rnd, prm, ch, carry=None) -> RoundOutputs:
        return self.solve_round(rnd, prm, ch, carry)


def get_scheduler(name: str) -> VedsScheduler:
    if name == "veds":
        return VedsScheduler()
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"scheduler {name!r} is not ported yet: the Section VI "
            f"benchmark schedulers come with the baselines slice of the "
            f"port; only 'veds' runs here")
    raise KeyError(f"unknown scheduler {name!r}; have ['veds'] "
                   f"(to be ported: {list(NOT_PORTED)})")
