"""vireoSNP's import path `vireoSNP.utils.variant_select` ->
models.variant_select."""
from ..models.variant_select import (  # noqa: F401
    barcode_entropy, variant_select, variant_ELBO_gain)
