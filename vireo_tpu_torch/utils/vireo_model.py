"""vireoSNP's import path `vireoSNP.utils.vireo_model` -> models.vireo."""
from ..models.vireo import *  # noqa: F401,F403
from ..models.vireo import Vireo  # noqa: F401
