"""lambdapic_torch: the PyTorch / CUDA port of lambdapic_tpu.

Runs the 2D and 3D cell-engine particle-in-cell step on one NVIDIA GPU, with
hand-written CUDA kernels for the fields half-step, the per-species
particle stage and the current fold (``csrc/``). Entry points run on
"cuda" unless given device="cpu", where the kernels' plain PyTorch
versions run instead.
"""
from .constants import c, e, epsilon_0, m_e, m_p, mu_0, pi  # noqa: F401
from .core.species import Electron, Photon, Proton, Species  # noqa: F401
from .models.laser import (GaussianLaser, GaussianLaser2D,  # noqa: F401
                           GaussianLaser3D, SimpleLaser, SimpleLaser2D,
                           SimpleLaser3D)
from .simulation.callbacks import Callback, callback  # noqa: F401
from .simulation.simulation import (Simulation, Simulation2D,  # noqa: F401
                                    Simulation3D)
