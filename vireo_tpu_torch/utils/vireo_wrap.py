"""vireoSNP's import path `vireoSNP.utils.vireo_wrap` -> engine.wrap."""
from ..engine.wrap import vireo_wrap  # noqa: F401
