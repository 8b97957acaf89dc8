"""vireoSNP's import path `vireoSNP.utils.vireo_doublet` ->
models.doublet and models.ambient."""
from ..models.doublet import (  # noqa: F401
    predict_doublet, add_doublet_theta, add_doublet_GT)
from ..models.ambient import predit_ambient  # noqa: F401
