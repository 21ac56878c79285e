"""Package metadata (role parity with the reference setup.py)."""

from setuptools import find_packages, setup

setup(
    name="deepsensornz_tpu",
    version="0.1.0",
    description=(
        "TPU-native ConvNP statistical downscaling of weather over New "
        "Zealand (JAX/XLA/Pallas)"
    ),
    packages=find_packages(exclude=("tests", "tests.*")),
    package_data={
        "deepsensornz_tpu": ["data/station_registry.json"],
        "deepsensornz_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "data/station_registry.json"],
    },
    include_package_data=True,
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
        "scipy",
        "pandas",
        "h5py",
        "pyyaml",
        "matplotlib",
    ],
)
