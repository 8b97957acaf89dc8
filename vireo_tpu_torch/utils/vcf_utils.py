"""vireoSNP's import path `vireoSNP.utils.vcf_utils` -> io.vcf."""
from ..io.vcf import *  # noqa: F401,F403
from ..io.vcf import __all__  # noqa: F401
