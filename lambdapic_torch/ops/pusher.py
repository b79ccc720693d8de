"""Particle pushers (counterpart of lambdapic_tpu/ops/pusher.py):
relativistic Boris rotation and the position push in cell units. Written
op for op like the JAX functions so both round alike."""
from __future__ import annotations

from typing import Tuple

import torch

from ..constants import c as c_light


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def boris_push(ux, uy, uz, ex_p, ey_p, ez_p, bx_p, by_p, bz_p,
               q: float, m: float, dt: float
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-dt Boris momentum update. Returns (ux, uy, uz, inv_gamma)."""
    efactor = _scalar(q * dt / (2 * m * c_light), ux)
    bfactor = _scalar(q * dt / (2 * m), ux)

    um_x = ux + efactor * ex_p
    um_y = uy + efactor * ey_p
    um_z = uz + efactor * ez_p
    inv_gamma_m = 1.0 / torch.sqrt(1.0 + um_x**2 + um_y**2 + um_z**2)
    tx = bfactor * bx_p * inv_gamma_m
    ty = bfactor * by_p * inv_gamma_m
    tz = bfactor * bz_p * inv_gamma_m
    up_x = um_x + um_y * tz - um_z * ty
    up_y = um_y + um_z * tx - um_x * tz
    up_z = um_z + um_x * ty - um_y * tx
    tfac = 2.0 / (1.0 + tx**2 + ty**2 + tz**2)
    sx = tfac * tx
    sy = tfac * ty
    sz = tfac * tz
    uplus_x = um_x + up_y * sz - up_z * sy
    uplus_y = um_y + up_z * sx - up_x * sz
    uplus_z = um_z + up_x * sy - up_y * sx
    ux_new = uplus_x + efactor * ex_p
    uy_new = uplus_y + efactor * ey_p
    uz_new = uplus_z + efactor * ez_p
    inv_gamma_new = 1.0 / torch.sqrt(1.0 + ux_new**2 + uy_new**2 + uz_new**2)
    return ux_new, uy_new, uz_new, inv_gamma_new


def photon_push(ux, uy, uz) -> torch.Tensor:
    """A photon's momentum push: inv_gamma = 1/|u| only, 1 where u = 0
    (dead slots)."""
    u2 = ux**2 + uy**2 + uz**2
    return torch.where(u2 > 0, 1.0 / torch.sqrt(torch.clamp(u2, min=1e-30)),
                       torch.ones_like(u2))


def push_position_2d(x, y, ux, uy, inv_gamma, cdt_dx: float, cdt_dy: float):
    """x += u inv_gamma c dt, in cell units (cdt_dx = c*dt/dx)."""
    x = x + ux * inv_gamma * _scalar(cdt_dx, x)
    y = y + uy * inv_gamma * _scalar(cdt_dy, y)
    return x, y


def push_position_3d(x, y, z, ux, uy, uz, inv_gamma, cdt_dx: float,
                     cdt_dy: float, cdt_dz: float):
    x = x + ux * inv_gamma * _scalar(cdt_dx, x)
    y = y + uy * inv_gamma * _scalar(cdt_dy, y)
    z = z + uz * inv_gamma * _scalar(cdt_dz, z)
    return x, y, z
