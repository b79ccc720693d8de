"""Monte-Carlo LCFA QED, nonlinear Compton photon emission (counterpart of
the Compton half of lambdapic_tpu/models/qed.py).

- chi per particle from the gathered E, B and the post-migration,
  pre-push momentum (kernel B2's ``want_chi`` mode emits it with the
  pre-push inv_gamma);
- optical depth: tau starts at -log(1-r), falls by the total emission
  rate * dt / gamma, and an event fires when it crosses zero; the photon's
  energy fraction delta is drawn from the inverse cumulative distribution;
- the rate and the inverse distribution are Chebyshev fits of the shipped
  tables (``_fit_tables``, host numpy, verbatim), evaluated without
  gathers; ``sample_mode="table"`` interpolates the tables instead;
- creation: newborn photons fill dead photon slots of the parent's cell
  (``ops/cell2d.py::insert_cells``), then the parent recoils.

Draws come from ``lambdapic_torch.random``, bit for bit jax.random's, keyed
on (seed, step, species, device 0) as in the JAX package. Breit-Wheeler
pair production is not ported (ROADMAP queue 1, item 9).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from .. import random as jr
from ..constants import c, e, hbar, m_e
from .qed_tables import load_tables

CHI_FACTOR = e * hbar / (m_e**2 * c**3)


def _np_dtype(dtype: torch.dtype):
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


def calculate_chi(ex_p, ey_p, ez_p, bx_p, by_p, bz_p, ux, uy, uz, inv_gamma):
    """Quantum parameter chi of each particle."""
    gamma = 1.0 / inv_gamma
    val = ((gamma * ex_p + (uy * bz_p - uz * by_p) * c)**2
           + (gamma * ey_p + (uz * bx_p - ux * bz_p) * c)**2
           + (gamma * ez_p + (ux * by_p - uy * bx_p) * c)**2
           - (ux * ex_p + uy * ey_p + uz * ez_p)**2)
    return CHI_FACTOR * torch.sqrt(torch.clamp(val, min=0.0))


@dataclass(frozen=True)
class _Tables:
    """The optical-depth tables in the working type (numpy) and their
    Chebyshev surrogates: log10(total rate) against the scaled log10(chi),
    and the r-uniform inverse CDF as a 2D fit (log10(delta) for photons).
    Device copies for the table mode are made on first use."""

    total: np.ndarray           # (chi_N,)
    cumulative: np.ndarray      # (chi_N, delta_N)
    log_chi_min: float
    log_chi_max: float
    log_chi_delta: float
    log_delta_min: float        # log10 of the smallest grid delta
    chi_N: int
    delta_N: int
    delta_grid: np.ndarray      # (delta_N,)
    rate_coef: np.ndarray       # (deg+1,)
    rate_c0: float              # fit domain [rate_c0, log_chi_max]
    inv_coef: np.ndarray        # (degc+1, degr+1)
    inv_c0: float
    inv_log_space: bool
    _dev: Dict = field(default_factory=dict, compare=False, repr=False)

    def on(self, name: str, device) -> torch.Tensor:
        key = (name, torch.device(device))
        t = self._dev.get(key)
        if t is None:
            t = torch.as_tensor(getattr(self, name)).to(device)
            self._dev[key] = t
        return t


def _fit_tables(total, cum, lo, hi, delta_grid, log_space,
                deg_rate=24, degc=16, degr=32):
    """Host-side Chebyshev fits of the rate and r-uniform inverse CDF."""
    from numpy.polynomial import chebyshev as C
    N, M = cum.shape
    cgrid = np.linspace(lo, hi, N)
    nz = total > total.max() * 1e-12
    i0 = int(nz.argmax())
    cs = cgrid[i0:]
    cc = 2 * (cs - cs[0]) / (hi - cs[0]) - 1
    rate_coef = C.chebfit(cc, np.log10(np.maximum(total[i0:], 1e-300)),
                          deg_rate)

    ld = np.log10(delta_grid)
    r_grid = np.linspace(0, 1, 513)
    inv = np.zeros((N - i0, r_grid.size))
    for i in range(i0, N):
        y = cum[i]
        y = (y - y[0]) / max(y[-1] - y[0], 1e-300)
        y = np.maximum.accumulate(y)
        v = np.interp(r_grid, y, ld)
        inv[i - i0] = v if log_space else 10.0 ** v
    w = np.arcsin(2 * r_grid - 1) / (np.pi / 2)
    V1 = C.chebvander(cc, degc)
    V2 = C.chebvander(w, degr)
    A = np.linalg.lstsq(V1, inv, rcond=None)[0]
    B = np.linalg.lstsq(V2, A.T, rcond=None)[0].T    # (degc+1, degr+1)
    return rate_coef, float(cs[0]), B


def _make_tables(kind: str, dtype: torch.dtype) -> _Tables:
    t = load_tables()
    npdt = _np_dtype(dtype)
    lo, hi = [float(v) for v in t["log_chi_range"]]
    delta_N = int(t["delta_N"])
    delta_grid = np.logspace(float(t["log_delta_range"][0]), 0, delta_N)
    total = np.asarray(t[f"{kind}_prob_rate_total"], np.float64)
    cum = np.asarray(t[f"integral_{kind}_prob_along_delta"], np.float64)
    log_space = kind == "photon"
    rate_coef, c0, inv_coef = _fit_tables(total, cum, lo, hi, delta_grid,
                                          log_space)
    return _Tables(
        total=total.astype(npdt), cumulative=cum.astype(npdt),
        log_chi_min=lo, log_chi_max=hi,
        log_chi_delta=float(t["log_chi_delta"]),
        log_delta_min=float(np.log10(delta_grid[0])),
        chi_N=int(t["chi_N"]), delta_N=delta_N,
        delta_grid=delta_grid.astype(npdt),
        rate_coef=rate_coef.astype(npdt), rate_c0=c0,
        inv_coef=inv_coef.astype(npdt), inv_c0=c0,
        inv_log_space=log_space)


def _clenshaw(x, coef):
    """Chebyshev series evaluation; ``coef`` entries are scalars."""
    b1 = torch.zeros_like(x)
    b2 = torch.zeros_like(x)
    for k in range(len(coef) - 1, 0, -1):
        b1, b2 = 2 * x * b1 - b2 + float(coef[k]), b1
    return x * b1 - b2 + float(coef[0])


def _interp(x, xp, fp):
    """jnp.interp with constant ends."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(_np_dtype(xp.dtype)).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _total_rate_table(chi, tb: _Tables):
    """Total event rate linearly interpolated in log10(chi); 0 below the
    table's range (the table mode)."""
    log_chi = torch.log10(torch.clamp(chi, min=1e-30))
    grid = tb.log_chi_min + tb.log_chi_delta * torch.arange(
        tb.chi_N, dtype=chi.dtype, device=chi.device)
    rate = _interp(log_chi, grid, tb.on("total", chi.device))
    return torch.where(log_chi >= tb.log_chi_min, rate, 0.0)


def _total_rate(chi, tb: _Tables):
    """Chebyshev surrogate of the total event rate: clamped to the fit's
    domain, 0 below the fit's start and below the table's range."""
    log_chi = torch.log10(torch.clamp(chi, min=1e-30))
    cc = 2 * (log_chi - tb.rate_c0) / (tb.log_chi_max - tb.rate_c0) - 1
    rate = torch.pow(10.0, _clenshaw(torch.clamp(cc, -1.0, 1.0),
                                     tb.rate_coef))
    lo_cut = max(tb.log_chi_min, tb.rate_c0)
    return torch.where(log_chi >= lo_cut, rate, 0.0)


def _cheb_basis(x, n):
    """[T_0(x) .. T_{n-1}(x)] by the three-term recurrence."""
    ts = [torch.ones_like(x), x]
    for _ in range(2, n):
        ts.append(2 * x * ts[-1] - ts[-2])
    return ts[:n]


def _sample_delta(chi, r01, tb: _Tables):
    """Energy fraction delta = F^-1(log10 chi, r) from the Chebyshev fit of
    the inverse CDF, r arcsine-warped: the tensor-product sum
    sum_km C[k,m] T_k(cc) T_m(w). The JAX package adds its terms one by
    one; here the sum is one matrix product of the two bases (the same
    polynomial, reassociated: it rounds differently in the last bits)."""
    log_chi = torch.log10(torch.clamp(chi, min=1e-30))
    cc = torch.clamp(2 * (log_chi - tb.inv_c0)
                     / (tb.log_chi_max - tb.inv_c0) - 1, -1.0, 1.0)
    w = torch.arcsin(2 * torch.clamp(r01, 0.0, 1.0) - 1) / (math.pi / 2)
    K, M = tb.inv_coef.shape
    tc = torch.stack(_cheb_basis(cc.reshape(-1), K))    # (K, n)
    tw = torch.stack(_cheb_basis(w.reshape(-1), M))     # (M, n)
    val = (tc * (tb.on("inv_coef", chi.device) @ tw)).sum(0).view_as(chi)
    if tb.inv_log_space:
        return torch.pow(10.0, torch.clamp(val, max=0.0))
    return torch.clamp(val, 10.0 ** tb.log_delta_min, 1.0)


def _sample_delta_table(chi, r01, tb: _Tables):
    """Energy fraction delta by bisection of the chi-interpolated
    cumulative table, interpolated in log10(delta) (the table mode)."""
    cum = tb.on("cumulative", chi.device)
    dgrid = tb.on("delta_grid", chi.device)
    log_chi = torch.log10(torch.clamp(chi, min=1e-30))
    fidx = (log_chi - tb.log_chi_min) / tb.log_chi_delta
    chi_idx = torch.clamp(torch.floor(fidx).to(torch.int64), 0, tb.chi_N - 2)
    t = fidx - chi_idx.to(chi.dtype)

    def entry(i):
        a = cum[chi_idx, i]
        b = cum[chi_idx + 1, i]
        return a * (1 - t) + b * t

    ymin = entry(torch.zeros_like(chi_idx))
    ymax = entry(torch.full_like(chi_idx, tb.delta_N - 1))
    r = r01 * (ymax - ymin) + ymin
    low = torch.zeros_like(chi_idx)
    high = torch.full_like(chi_idx, tb.delta_N - 1)
    for _ in range(int(np.ceil(np.log2(tb.delta_N))) + 1):
        mid = torch.div(low + high, 2, rounding_mode="floor")
        go_up = entry(mid) < r
        low = torch.where(go_up, mid + 1, low)
        high = torch.where(go_up, high, mid - 1)
    delta_idx = torch.clamp(high, 0, tb.delta_N - 2)
    y1 = entry(delta_idx)
    y2 = entry(delta_idx + 1)
    frac = (r - y1) / torch.where(y2 != y1, y2 - y1, 1e-300)
    d1, d2 = dgrid[delta_idx], dgrid[delta_idx + 1]
    log_delta = torch.log10(d1) + frac * (torch.log10(d2) - torch.log10(d1))
    return torch.pow(10.0, torch.clamp(log_delta, max=0.0))


def _sample_delta_sparse(chi, r01, event, tb: _Tables):
    """Delta for cell layouts (chi of shape (cap, *cells)), evaluated at
    the event slots only: they are packed into one row (one host
    synchronisation to find them), the inverse CDF runs there, and the
    results go back to their slots. The JAX package packs each cell's
    events into the cell's first K rows and evaluates every slot when a
    cell holds more than K. Any packing gives the same values but for
    the rounding of the Chebyshev sum's matrix product, whose order may
    follow the number of columns: the result equals
    ``where(event, _sample_delta(chi, r01), 0)`` to that rounding."""
    idx = event.reshape(-1).nonzero().squeeze(1)
    d = torch.zeros_like(chi).reshape(-1)
    d[idx] = _sample_delta(chi.reshape(-1)[idx], r01.reshape(-1)[idx], tb)
    return d.view_as(chi)


def _update_tau(tau, inv_gamma, chi, alive, dt, keys, tb: _Tables,
                strict_less: bool, sample_mode: str = "chebyshev"):
    """Optical-depth decrement and event flag; returns (tau, event,
    delta). ``keys``: three keys (2,) for the three uniform draws over
    tau's shape. strict_less: photon emission fires at tau < 0, pair
    production at tau <= 0."""
    chi_min = 10.0 ** tb.log_chi_min
    active = alive & (chi >= chi_min)
    # the draws are made at the alive slots only (one host synchronisation
    # to find them): nothing reads them elsewhere
    idx = alive.reshape(-1).nonzero().squeeze(1)

    def draw(key):
        u = jr.uniform(key, tau.shape, tau.dtype, device=tau.device,
                       index=idx)
        return torch.zeros_like(tau).reshape(-1).index_copy_(0, idx, u
                                                             ).view_as(tau)
    u1, u2, u3 = (draw(k) for k in keys)
    table_mode = sample_mode == "table"
    rate = (_total_rate_table if table_mode else _total_rate)(chi, tb)
    tau_init = torch.where((tau == 0.0) | torch.isnan(tau),
                           -torch.log1p(-u1), tau)
    tau_new = tau_init - rate * dt * inv_gamma
    crossed = tau_new < 0 if strict_less else tau_new <= 0
    event = active & crossed
    tau_out = torch.where(event, -torch.log1p(-u2), tau_new)
    tau_out = torch.where(active, tau_out, tau)
    if not table_mode and chi.ndim >= 2:
        delta = _sample_delta_sparse(chi, u3, event, tb)
    else:
        sampler = _sample_delta_table if table_mode else _sample_delta
        delta = torch.where(event, sampler(chi, u3, tb), 0.0)
    return tau_out, event, delta


class NonlinearComptonLCFA:
    """Photon emission by species ``ispec`` into species ``photon_ispec``
    (the JAX class's ``buf``, a creation buffer of its scatter engine, has
    no use in the cell engine and is not taken)."""

    def __init__(self, ispec: int, photon_ispec: int, dtype=torch.float32,
                 sample_mode: str = "chebyshev"):
        if sample_mode not in ("chebyshev", "table"):
            raise ValueError(
                f"sample_mode must be 'chebyshev' or 'table', got "
                f"{sample_mode!r}")
        self.ispec = ispec
        self.photon_ispec = photon_ispec
        self.tables = _make_tables("photon", dtype)
        self.sample_mode = sample_mode

    def update_chi_and_events(self, data, alive, key, dt):
        """Events from the gathered fields stored in ``data`` (``*_part``)
        and its momenta and inv_gamma."""
        chi = calculate_chi(
            data["ex_part"], data["ey_part"], data["ez_part"],
            data["bx_part"], data["by_part"], data["bz_part"],
            data["ux"], data["uy"], data["uz"], data["inv_gamma"])
        return self.update_events_from_chi(data, alive, key, dt, chi,
                                           data["inv_gamma"])

    def update_events_from_chi(self, data, alive, key, dt, chi, ig_pre):
        """Events from a chi and a pre-push inv_gamma computed elsewhere
        (kernel B2's ``want_chi`` mode). ``key``: the species' key of this
        step on this device."""
        data = dict(data)
        data["chi"] = torch.where(alive, chi, 0.0)
        keys = jr.split(jr.fold_in(key, 101), 3)
        tau, event, delta = _update_tau(
            data["tau"], ig_pre, data["chi"], alive, dt, keys,
            self.tables, strict_less=True, sample_mode=self.sample_mode)
        data["tau"] = tau
        data["event"] = event.to(data["tau"].dtype)
        data["delta"] = delta
        return data, alive

    def photon_newborns(self, edata, ndim: int):
        """Newborn photon values at their parents' slots: the parent's
        position and weight, momentum delta * u, inv_gamma 1/|u|."""
        delta = edata["delta"]
        ux = delta * edata["ux"]
        uy = delta * edata["uy"]
        uz = delta * edata["uz"]
        u2 = ux**2 + uy**2 + uz**2
        new = {"x": edata["x"], "y": edata["y"], "w": edata["w"],
               "ux": ux, "uy": uy, "uz": uz,
               "inv_gamma": torch.where(u2 > 0, 1.0 / torch.sqrt(
                   torch.clamp(u2, min=1e-30)), 1.0)}
        if ndim == 3:
            new["z"] = edata["z"]
        return new

    def apply_recoil(self, edata, ev):
        """Parent recoil u *= 1 - delta where an event fired, and the
        event flags reset."""
        edata = dict(edata)
        fac = torch.where(ev, 1.0 - edata["delta"], 1.0)
        edata["ux"] = edata["ux"] * fac
        edata["uy"] = edata["uy"] * fac
        edata["uz"] = edata["uz"] * fac
        edata["inv_gamma"] = 1.0 / torch.sqrt(
            1.0 + edata["ux"]**2 + edata["uy"]**2 + edata["uz"]**2)
        edata["event"] = torch.zeros_like(edata["event"])
        return edata


def species_key(base_key: torch.Tensor, itime: int, ispec: int,
                didx: int = 0) -> torch.Tensor:
    """The key of species ``ispec`` at step ``itime`` on the shard of
    row-major device index ``didx`` over the mesh axes (0 on one device):
    fold_in(fold_in(fold_in(base, itime), ispec), didx), as
    lambdapic_tpu/simulation/step.py folds the device index in."""
    return jr.fold_in(jr.fold_in(jr.fold_in(base_key, itime), ispec), didx)
