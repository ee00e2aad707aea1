from setuptools import find_packages, setup

with open("pyroved_tpu/__version__.py") as f:
    exec(f.read())

setup(
    name="pyroved_tpu",
    version=__version__,  # noqa: F821
    description=("TPU-native variational encoder-decoder framework: invariant "
                 "VAEs, joint discrete-continuous and semi-supervised VAEs, "
                 "and im2spec/spec2im models in JAX/XLA/Pallas"),
    long_description=open("README.md").read(),
    long_description_content_type="text/markdown",
    packages=find_packages(exclude=["tests*", "benchmarks*", "examples*"]),
    package_data={"pyroved_tpu": ["py.typed"],
                  "pyroved_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax>=0.4.30",
        "flax>=0.8",
        "optax>=0.2",
        "numpy>=1.24",
    ],
    extras_require={
        "viz": ["matplotlib>=3.2"],
        "test": ["pytest", "torch"],
        "torch": ["torch>=2.1", "numpy>=1.24"],
    },
    classifiers=[
        "Programming Language :: Python :: 3",
        "Topic :: Scientific/Engineering :: Artificial Intelligence",
        "Operating System :: OS Independent",
    ],
)
