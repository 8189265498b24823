"""3GPP TR 37.885 urban V2X channel model (Table I of the paper).

Port of `repro/channel/v2x.py`.

Pathloss:
  LOS / NLOSv: PL = 38.77 + 16.7 log10(d) + 18.2 log10(fc[GHz])
  NLOS:        PL = 36.85 + 30   log10(d) + 18.9 log10(fc[GHz])
Shadowing: log-normal, sigma = 3 dB (LOS/NLOSv), 4 dB (NLOS).
NLOSv adds vehicle-blockage loss max{0, N(5, 4)} dB.
Small-scale fading: Rayleigh (exponential power).

`channel_gain` is split in two: `channel_draws` makes every random number
from a `torch.Generator`, and `gain_from_draws` is the deterministic rest,
so tests can feed it the reference's own draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from repro_torch import device_scalar


@dataclasses.dataclass(frozen=True)
class ChannelParams:
    bandwidth: float = 20e6          # Hz (whole band used by the slot owner)
    fc_ghz: float = 5.9              # carrier [GHz]
    noise_dbm_hz: float = -174.0     # noise PSD
    p_max: float = 0.3               # W
    shadow_los_db: float = 3.0
    shadow_nlos_db: float = 4.0
    blockage_mean_db: float = 5.0
    blockage_std_db: float = 2.0
    los_d0: float = 150.0            # LOS probability scale [m]

    @property
    def noise_power(self) -> float:
        """Total noise over the band: N0 * B [W]."""
        return 10.0 ** (self.noise_dbm_hz / 10.0) * 1e-3 * self.bandwidth


def pathloss_db(d: torch.Tensor, prm: ChannelParams, los: torch.Tensor,
                blocked: torch.Tensor,
                block_loss_db: torch.Tensor) -> torch.Tensor:
    d = torch.clamp_min(d, 1.0)
    lg = torch.log10(d)
    lf = math.log10(prm.fc_ghz)
    pl_los = 38.77 + 16.7 * lg + 18.2 * lf
    pl_nlos = 36.85 + 30.0 * lg + 18.9 * lf
    pl = torch.where(los, pl_los, pl_nlos)
    # NLOSv: LOS pathloss + vehicle blockage loss
    return pl + torch.where(los & blocked, block_loss_db, 0.0)


def channel_draws(gen: torch.Generator, shape,
                  device) -> Dict[str, torch.Tensor]:
    """Every random number one `channel_gain` call needs, from `gen`:
    uniforms for the LOS and blockage Bernoullis, standard normals for
    the blockage loss and the shadowing, unit exponentials for fading."""
    def u():
        return torch.rand(shape, generator=gen, device=device)

    def n():
        return torch.randn(shape, generator=gen, device=device)

    u_los, u_blocked, z_block, z_shadow = u(), u(), n(), n()
    fading = torch.empty(shape, device=device).exponential_(generator=gen)
    return dict(u_los=u_los, u_blocked=u_blocked, z_block=z_block,
                z_shadow=z_shadow, fading=fading)


def gain_from_draws(d: torch.Tensor, prm: ChannelParams,
                    draws: Dict[str, torch.Tensor],
                    in_range: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The deterministic half of `channel_gain`: linear power gain
    |h|^2 for each entry of `d`, given the draws of `channel_draws`."""
    p_los = torch.exp(-torch.clamp_min(d - 10.0, 0.0) / prm.los_d0)
    los = draws["u_los"] < torch.clamp(p_los, 0.05, 1.0)
    blocked = draws["u_blocked"] < 0.3
    bl = torch.clamp_min(
        prm.blockage_mean_db + prm.blockage_std_db * draws["z_block"], 0.0)
    pl = pathloss_db(d, prm, los, blocked, bl)
    sigma = torch.where(los, prm.shadow_los_db, prm.shadow_nlos_db)
    shadow = sigma * draws["z_shadow"]
    g = 10.0 ** (-(pl + shadow) / 10.0) * draws["fading"]
    if in_range is not None:
        g = torch.where(in_range, g, 0.0)
    return g


def channel_gain(gen: torch.Generator, d: torch.Tensor, prm: ChannelParams,
                 in_range: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Linear power gain |h|^2 for each entry of the distance array `d`."""
    return gain_from_draws(d, prm, channel_draws(gen, d.shape, d.device),
                           in_range)


def snr(p: torch.Tensor, gain: torch.Tensor,
        prm: ChannelParams) -> torch.Tensor:
    return p * gain / device_scalar(prm.noise_power, gain)


def rate_dt(p: torch.Tensor, gain: torch.Tensor,
            prm: ChannelParams) -> torch.Tensor:
    """Direct-transmission rate [bit/s]."""
    return prm.bandwidth * torch.log2(1.0 + snr(p, gain, prm))


def rate_cot(p_m, g_m, p_n, g_n, prm: ChannelParams) -> torch.Tensor:
    """Cooperative (DSTC) rate: SOV + scheduled OPVs combine at the RSU.

    p_n, g_n: arrays over OPVs (zero power => excluded).
    """
    noise = device_scalar(prm.noise_power, g_m)
    s = p_m * g_m / noise + torch.sum(p_n * g_n / noise, dim=-1)
    return prm.bandwidth * torch.log2(1.0 + s)
