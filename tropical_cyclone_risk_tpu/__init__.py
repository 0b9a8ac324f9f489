"""tropical_cyclone_risk_tpu: a JAX tropical-cyclone downscaling framework.

A from-scratch JAX/XLA re-design of the capabilities of the
linjonathan/tropical_cyclone_risk statistical-dynamical downscaling model
(Lin et al. 2023): random seeding genesis, intensity-dependent beta-advection
tracks, and coupled FAST ocean-atmosphere intensity ODEs — all as one vmapped
fixed-step integration over thousands of seeds with device-resident environment
fields and jax.random streams.
"""

from tropical_cyclone_risk_tpu.config import Namelist, load_namelist_py

__version__ = '0.1.0'

__all__ = ['Namelist', 'load_namelist_py', '__version__']
