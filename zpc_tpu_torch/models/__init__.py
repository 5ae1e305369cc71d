"""Constitutive models and CFL (counterpart of ``zpc_tpu/models``)."""

from .constitutive import (ElasticModel, NeoHookean, FixedCorotated,
                           StvkWithHencky, EquationOfState,
                           AnisotropicArap, lame_parameters, bcast_scalar)
from .plasticity import (SnowPlasticity, VonMisesCapped, DruckerPrager,
                         NACC, NonAssociativeVonMises, AssociativeVonMises)
from .cfl import (sound_speed, timestep_linear_elasticity, timestep_velocity)
