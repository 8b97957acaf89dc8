"""vireoSNP's import path `vireoSNP.utils.io_utils` -> io.matrices."""
from ..io.matrices import *  # noqa: F401,F403
from ..io.matrices import __all__  # noqa: F401
