"""Optical-depth tables of the Monte-Carlo QED processes (counterpart of
``load_tables`` in lambdapic_tpu/models/qed_tables.py, default log-grid
variant only).

The tables are the JAX package's shipped data file
``lambdapic_tpu/models/optical_depth_tables.npz``, read in place and never
written: the port keeps no copy. Generating them (``table_gen``) and the
sigmoid-warped variant are not ported (ROADMAP queue 1, item 9).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

TABLE_PATH = (Path(__file__).resolve().parents[2] / "lambdapic_tpu" /
              "models" / "optical_depth_tables.npz")

_cache: Dict[str, Dict[str, np.ndarray]] = {}


def load_tables() -> Dict[str, np.ndarray]:
    """The log-grid tables as numpy arrays: total rates
    ``{photon,pair}_prob_rate_total`` (chi_N,), cumulative distributions
    ``integral_{photon,pair}_prob_along_delta`` (chi_N, delta_N) and their
    grid scalars. Raises if the data file is missing."""
    if "log" not in _cache:
        if not TABLE_PATH.exists():
            raise FileNotFoundError(
                f"QED tables not found at {TABLE_PATH}; the port reads the "
                "JAX package's shipped file and does not generate it")
        with np.load(TABLE_PATH) as f:
            _cache["log"] = {k: f[k] for k in f.files}
    return _cache["log"]
