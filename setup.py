from setuptools import find_packages, setup

setup(
    name="liftreg_tpu",
    version="0.1.0",
    description="TPU-native 2D/3D deformable registration framework "
                "(JAX/XLA/Pallas)",
    packages=find_packages(include=["liftreg_tpu", "liftreg_tpu.*",
                                    "liftreg_tpu_torch",
                                    "liftreg_tpu_torch.*"]),
    package_data={"liftreg_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy", "scipy"],
)
