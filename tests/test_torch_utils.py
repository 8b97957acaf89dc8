"""The vireoSNP import paths of `vireo_tpu_torch.utils` (the port's
counterparts of `vireo_tpu/utils/`'s aliases, tests/test_utils.py): each
name is the port's own object, and each alias imports without jax and
without vireo_tpu."""

import importlib
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

ALIASES = ("base_utils", "bmm_model", "io_utils", "variant_select",
           "vcf_utils", "vireo_base", "vireo_bulk", "vireo_doublet",
           "vireo_model", "vireo_wrap")

# alias -> (the port's module, the names the JAX alias re-exports by name)
NAMES = {
    "base_utils": ("ops.matching", ["get_confusion"]),
    "bmm_model": ("models.bmm", ["BinomMixtureVB"]),
    "io_utils": ("io.matrices", ["read_cellSNP", "write_donor_id"]),
    "variant_select": ("models.variant_select",
                       ["barcode_entropy", "variant_select",
                        "variant_ELBO_gain"]),
    "vcf_utils": ("io.vcf", ["load_VCF", "parse_donor_GPb"]),
    "vireo_base": ("base", ["normalize", "optimal_match"]),
    "vireo_bulk": ("models.bulk", ["VireoBulk", "LikRatio_test"]),
    "vireo_doublet": ("models.doublet", ["predict_doublet",
                                         "add_doublet_theta",
                                         "add_doublet_GT"]),
    "vireo_model": ("models.vireo", ["Vireo"]),
    "vireo_wrap": ("engine.wrap", ["vireo_wrap"]),
}


def test_reference_import_path_aliases():
    """Scripts written against vireoSNP.utils.* port by renaming the
    package only (as tests/test_utils.py does for vireo_tpu)."""
    from vireo_tpu_torch.utils.vireo_model import Vireo
    from vireo_tpu_torch.utils.bmm_model import BinomMixtureVB
    from vireo_tpu_torch.utils.vireo_bulk import VireoBulk, LikRatio_test
    from vireo_tpu_torch.utils.vireo_wrap import vireo_wrap
    from vireo_tpu_torch.utils.vireo_doublet import predict_doublet
    from vireo_tpu_torch.utils.vcf_utils import load_VCF, parse_donor_GPb
    from vireo_tpu_torch.utils.io_utils import read_cellSNP, write_donor_id
    from vireo_tpu_torch.utils.vireo_base import normalize, optimal_match
    from vireo_tpu_torch.utils.base_utils import get_confusion
    from vireo_tpu_torch.utils.variant_select import variant_select
    for obj in (Vireo, BinomMixtureVB, VireoBulk, LikRatio_test,
                vireo_wrap, predict_doublet, load_VCF, parse_donor_GPb,
                read_cellSNP, write_donor_id, normalize, optimal_match,
                get_confusion, variant_select):
        assert callable(obj)


@pytest.mark.parametrize("alias", ALIASES)
def test_alias_names_are_the_ports_own(alias):
    """Each name is the object of the port's module (e.g.
    utils.vireo_model.Vireo is models.vireo.Vireo), and a star alias
    carries its module's whole __all__."""
    mod = importlib.import_module("vireo_tpu_torch.utils." + alias)
    home_name, names = NAMES[alias]
    home = importlib.import_module("vireo_tpu_torch." + home_name)
    for name in names:
        assert getattr(mod, name) is getattr(home, name), name
    if alias in ("io_utils", "vcf_utils", "vireo_base", "vireo_model"):
        for name in home.__all__:
            assert getattr(mod, name) is getattr(home, name), name


def test_aliases_reaching_a_second_module():
    """vireo_doublet also carries the ambient call, vireo_base the
    binomial coefficients (as the reference's modules do)."""
    from vireo_tpu_torch.models import ambient
    from vireo_tpu_torch.ops import math
    from vireo_tpu_torch.utils import vireo_base, vireo_doublet
    assert vireo_doublet.predit_ambient is ambient.predit_ambient
    assert vireo_base.get_binom_coeff is math.get_binom_coeff


def test_the_aliases_match_the_jax_package():
    """The port has an alias for each of vireo_tpu/utils/'s, and each
    carries the JAX alias's public names of the JAX package's own
    (not numpy's or scipy's, which a star import also brings)."""
    jax_utils = REPO / "vireo_tpu" / "utils"
    port_utils = REPO / "vireo_tpu_torch" / "utils"
    for alias in ALIASES:
        assert (jax_utils / (alias + ".py")).is_file()
        assert (port_utils / (alias + ".py")).is_file()
    for alias in ALIASES:
        jmod = importlib.import_module("vireo_tpu.utils." + alias)
        tmod = importlib.import_module("vireo_tpu_torch.utils." + alias)
        public = [n for n, obj in vars(jmod).items()
                  if not n.startswith("_")
                  and getattr(obj, "__module__", "").startswith("vireo_tpu")]
        missing = [n for n in public if not hasattr(tmod, n)]
        assert not missing, (alias, missing)


BLOCK = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "vireo_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
"""


def test_aliases_import_without_jax_or_vireo_tpu():
    code = BLOCK + (
        "import importlib\n"
        "for a in %r:\n"
        "    importlib.import_module('vireo_tpu_torch.utils.' + a)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'vireo_tpu'))\n"
        "assert not bad, bad\n" % (ALIASES,))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
