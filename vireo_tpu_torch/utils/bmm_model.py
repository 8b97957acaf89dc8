"""vireoSNP's import path `vireoSNP.utils.bmm_model` -> models.bmm."""
from ..models.bmm import BinomMixtureVB  # noqa: F401
