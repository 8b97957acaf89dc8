"""vireo-tpu: TPU-native donor deconvolution for multiplexed scRNA-seq."""

from setuptools import setup, find_packages

exec(open("./vireo_tpu/version.py").read())

setup(
    name="vireo-tpu",
    version=__version__,  # noqa: F821
    description="TPU-native donor deconvolution for multiplexed "
                "single-cell RNA-seq (JAX/XLA)",
    packages=find_packages(exclude=("tests",)),
    package_data={"vireo_tpu.io._native": ["*.cpp"],
                  "vireo_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["numpy", "scipy", "jax", "matplotlib"],
    entry_points={
        "console_scripts": [
            "vireo = vireo_tpu.cli.vireo_cli:main",
            "GTbarcode = vireo_tpu.cli.gtbarcode_cli:main",
            "vireo-torch = vireo_tpu_torch.cli.vireo_cli:main",
        ],
    },
)
