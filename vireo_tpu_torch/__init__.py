"""vireo-tpu-torch: the PyTorch/CUDA port of vireo-tpu.

A second package beside `vireo_tpu` (the JAX reference). It keeps the
JAX package's module layout and public names, so each module here has a
counterpart of the same path under `vireo_tpu/`. It imports torch,
numpy and scipy only: never jax, and never `vireo_tpu` (whose package
import pulls in jax).

The top-level names of vireo_tpu/__init__.py resolve here too (the
reference's surface: `vcf`, `base`, `model`, the math and matching
helpers, the counts classes, the models, `vireo_wrap`, the VCF and
cellSNP readers, `plot`), but lazily: `import vireo_tpu_torch` imports
no submodule, and each name imports its module on first use.
"""

import importlib

from .version import __version__

# name -> (submodule, attribute of it; None: the submodule itself)
_LAZY = {
    "vcf": ("io.vcf", None),
    "base": ("base", None),
    "model": ("models.vireo", None),
    "plot": ("plot", None),
    "Vireo": ("models.vireo", "Vireo"),
    "BinomMixtureVB": ("models.bmm", "BinomMixtureVB"),
    "VireoBulk": ("models.bulk", "VireoBulk"),
    "LikRatio_test": ("models.bulk", "LikRatio_test"),
    "vireo_wrap": ("engine.wrap", "vireo_wrap"),
    "read_cellSNP": ("io.matrices", "read_cellSNP"),
    "read_vartrix": ("io.matrices", "read_vartrix"),
}
_LAZY.update({name: ("ops.math", name) for name in (
    "normalize", "loglik_amplify", "beta_entropy", "get_binom_coeff")})
_LAZY.update({name: ("ops.matching", name) for name in (
    "match", "optimal_match", "donor_select", "get_confusion")})
_LAZY.update({name: ("ops.counts", name) for name in (
    "Counts", "dense_counts", "sparse_counts", "counts_from_scipy",
    "HybridCounts")})
_LAZY.update({name: ("io.vcf", name) for name in (
    "load_VCF", "write_VCF", "parse_donor_GPb", "match_SNPs")})

__all__ = ["__version__", "ops", "models", "engine", "io", "plot"]


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError("module %r has no attribute %r"
                             % (__name__, name))
    module, attr = _LAZY[name]
    value = importlib.import_module("." + module, __name__)
    if attr is not None:
        value = getattr(value, attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
