"""Species declarations (counterpart of lambdapic_tpu/core/species.py).

Density / ppc / momentum profiles are plain Python callables evaluated
on the host with numpy at initialisation; scalar-only profiles are
wrapped with ``np.vectorize``. The JAX package validates the fields with
pydantic; here the same checks are written out and raise ValueError.
"""
from __future__ import annotations

import inspect
import numbers
from dataclasses import dataclass, field
from typing import Callable, Optional, Union

import numpy as np

from ..constants import e, m_e, m_p

# Species created by a user script are picked up by the Simulation when
# none are added explicitly (as in lambdapic_tpu/core/species.py).
_ALL_SPECIES: list["Species"] = []

_PUSHERS = ("boris", "photon", "boris+tbmt")

BASE_ATTRS = (
    "x", "y", "z", "w", "ux", "uy", "uz", "inv_gamma",
    "ex_part", "ey_part", "ez_part", "bx_part", "by_part", "bz_part",
)
# QED attributes of a species with a QED process; 'event' is a float (0/1)
# so that it moves with the particle through the re-binning
QED_ATTRS = ("chi", "tau", "delta", "event")


def _validate(sp: "Species") -> None:
    if not isinstance(sp.name, str):
        raise ValueError(f"name must be a string, got {sp.name!r}")
    if isinstance(sp.charge, bool) or not isinstance(sp.charge, numbers.Integral):
        raise ValueError(f"charge must be an integer, got {sp.charge!r}")
    if isinstance(sp.mass, bool) or not isinstance(sp.mass, numbers.Real):
        raise ValueError(f"mass must be a number, got {sp.mass!r}")
    if sp.density is not None and not callable(sp.density):
        raise ValueError(f"density must be callable or None, got {sp.density!r}")
    if not isinstance(sp.density_min, numbers.Real):
        raise ValueError(f"density_min must be a number, got {sp.density_min!r}")
    if not (callable(sp.ppc) or (isinstance(sp.ppc, numbers.Integral)
                                 and not isinstance(sp.ppc, bool))):
        raise ValueError(f"ppc must be an int or callable, got {sp.ppc!r}")
    if sp.momentum is not None and not isinstance(sp.momentum, tuple):
        raise ValueError(f"momentum must be a tuple, got {sp.momentum!r}")
    if sp.polarization is not None and not isinstance(sp.polarization, tuple):
        raise ValueError(
            f"polarization must be a tuple, got {sp.polarization!r}")
    if sp.pusher not in _PUSHERS:
        raise ValueError(f"pusher must be one of {_PUSHERS}, got {sp.pusher!r}")
    if sp.capacity is not None and not isinstance(sp.capacity, numbers.Integral):
        raise ValueError(f"capacity must be an int, got {sp.capacity!r}")


@dataclass(kw_only=True)
class Species:
    """Particle species.

    Parameters:
        name: species name
        charge: charge number (multiples of e)
        mass: mass in units of electron mass
        density: density profile, callable of (x, y) in SI metres -> m^-3
        density_min: minimum density threshold
        ppc: particles per cell (int or callable of coordinates)
        momentum: tuple of profiles for initial ux, uy, uz
        polarization: spin polarisation vector (not supported by the port)
        pusher: "boris" | "photon" | "boris+tbmt"
        capacity: minimum particle capacity per device
    """

    name: str
    charge: int
    mass: float

    density: Optional[Callable] = field(default=None)
    density_min: float = field(default=0.0)
    ppc: Union[int, Callable] = field(default=0)
    momentum: Optional[tuple] = field(default=(None, None, None))
    polarization: Optional[tuple] = field(default=None)
    pusher: str = field(default="boris")
    capacity: Optional[int] = field(default=None)

    def __post_init__(self):
        _validate(self)
        self.m = self.mass * m_e
        self.q = self.charge * e
        self._aux_attrs: list[str] = []
        self._ispec: int | None = None
        _ALL_SPECIES.append(self)

    def is_compatible(self, dimension: int) -> bool:
        """True if the density/ppc profile arity fits ``dimension``."""
        for func in (self.density, self.ppc):
            if func is None or not inspect.isfunction(func):
                continue
            if func.__code__.co_argcount != dimension:
                return False
        return True

    @staticmethod
    def vectorized_profile(func_or_val, dimension: int) -> Callable:
        """A numpy-vectorised profile of ``dimension`` coordinate args:
        constants become constant fields; callables are probed with
        array inputs and wrapped in np.vectorize if they are scalar-only."""
        if isinstance(func_or_val, (int, float)):
            val = float(func_or_val)

            def const(*coords):
                return np.full(np.broadcast(*coords).shape, val)

            return const
        if not callable(func_or_val):
            raise ValueError(f"Invalid profile {func_or_val!r}")
        narg = getattr(func_or_val, "__code__", None)
        if narg is not None and func_or_val.__code__.co_argcount != dimension:
            raise ValueError(
                f"profile {func_or_val} must have {dimension} arguments")

        def wrapped(*coords):
            try:
                out = func_or_val(*coords)
                out = np.asarray(out, dtype=np.float64)
                if out.shape != np.broadcast(*coords).shape:
                    raise ValueError
                return out
            except Exception:
                # scalar-only profile (e.g. `if x > a:`): evaluate per point
                return np.vectorize(func_or_val, otypes=[np.float64])(*coords)

        return wrapped

    @property
    def ispec(self) -> int:
        if self._ispec is None:
            raise ValueError(
                "Species index is not set. Maybe not added via Simulation")
        return self._ispec

    @ispec.setter
    def ispec(self, value: int):
        self._ispec = value

    def attrs(self) -> tuple[str, ...]:
        """Per-particle float attributes carried by this species (with
        ``QED_ATTRS`` when it has a QED process)."""
        out = BASE_ATTRS + tuple(self._aux_attrs)
        return out + QED_ATTRS if self.has_qed else out

    @property
    def has_qed(self) -> bool:
        return False

    @property
    def has_spin(self) -> bool:
        return self.polarization is not None


@dataclass(kw_only=True)
class Electron(Species):
    """Electron. ``radiation="photons"`` with ``set_photon`` makes it emit
    photons (nonlinear Compton, models/qed.py); ``radiation="ll"`` is
    accepted and ignored with a warning, as in the JAX package."""

    name: str = field(default="electron")
    radiation: Optional[str] = field(default=None)
    charge: int = field(default=-1, init=False)
    mass: float = field(default=1.0, init=False)

    def __post_init__(self):
        if self.radiation not in (None, "ll", "photons"):
            raise ValueError(
                f"radiation must be None, 'll' or 'photons', got "
                f"{self.radiation!r}")
        super().__post_init__()
        self.photon: Optional[Species] = None

    def set_photon(self, photon: "Species"):
        if self.radiation != "photons":
            raise ValueError("radiation must be 'photons'")
        if not isinstance(photon, Species):
            raise TypeError(f"not a Species: {photon!r}")
        self.photon = photon

    @property
    def has_qed(self) -> bool:
        return self.photon is not None


@dataclass(kw_only=True)
class Proton(Species):
    name: str = field(default="proton")
    charge: int = field(default=1, init=False)
    mass: float = field(default=m_p / m_e, init=False)


@dataclass(kw_only=True)
class Photon(Species):
    """Photon species for QED: q = m = 0, pushed along its momentum."""

    name: str = field(default="photon")
    charge: int = field(default=0, init=False)
    mass: float = field(default=0.0, init=False)
    pusher: str = field(default="photon", init=False)

    def __post_init__(self):
        super().__post_init__()
        self.electron: Optional[Species] = None
        self.positron: Optional[Species] = None

    def set_bw_pair(self, *, electron: Species, positron: Species):
        """Breit-Wheeler pair production into ``electron`` / ``positron``
        (the Simulation refuses it until it is ported)."""
        for sp in (electron, positron):
            if not isinstance(sp, Species):
                raise TypeError(f"not a Species: {sp!r}")
        self.electron = electron
        self.positron = positron

    @property
    def has_qed(self) -> bool:
        return self.electron is not None
