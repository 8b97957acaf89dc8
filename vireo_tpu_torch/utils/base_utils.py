"""vireoSNP's import path `vireoSNP.utils.base_utils`: `get_confusion`."""
from ..ops.matching import get_confusion  # noqa: F401
