"""vireoSNP's import path `vireoSNP.utils.vireo_base` -> base, with
`get_binom_coeff` (ops.math) as in the reference's module."""
from ..base import *  # noqa: F401,F403
from ..ops.math import get_binom_coeff  # noqa: F401
