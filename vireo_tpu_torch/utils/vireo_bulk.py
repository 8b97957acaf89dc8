"""vireoSNP's import path `vireoSNP.utils.vireo_bulk` -> models.bulk."""
from ..models.bulk import VireoBulk, LikRatio_test  # noqa: F401
