"""Physical constants (SI), re-exported from scipy.constants so user
scripts written for the JAX package (lambdapic_tpu/constants.py) port
unchanged."""
from scipy.constants import (  # noqa: F401
    c,
    e,
    epsilon_0,
    m_e,
    m_p,
    mu_0,
    pi,
    h,
    hbar,
    k as k_B,
    alpha as fine_structure,
)

# Classical electron radius and Schwinger field.
r_e = e**2 / (4 * pi * epsilon_0 * m_e * c**2)
E_schwinger = m_e**2 * c**3 / (e * hbar)
