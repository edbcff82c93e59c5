"""Package installer (parity: reference setup.py console-script layout)."""

from setuptools import find_packages, setup

install_requires = [
    "jax",
    "numpy",
    "h5py",
    "optax",
]

setup(
    name="chiron_tpu",
    version="0.1.0",
    description=(
        "A TPU-native deep neural network basecaller for nanopore sequencing"
    ),
    long_description=(
        "From-scratch JAX/XLA/Pallas re-design of the Chiron basecaller: "
        "CNN+BiLSTM CTC models, fused TPU kernels for the recurrence and "
        "beam search, overlap-consensus assembly, data-parallel training "
        "and serving."
    ),
    license="MPL 2.0",
    packages=find_packages(include=["chiron_tpu", "chiron_tpu.*",
                                    "chiron_tpu_torch", "chiron_tpu_torch.*"]),
    package_data={"chiron_tpu": ["native/Makefile", "native/*.cc"],
                  "chiron_tpu_torch": ["csrc/*.cu", "native/*.cc"]},
    install_requires=install_requires,
    entry_points={
        "console_scripts": [
            "chiron=chiron_tpu.cli:main",
            "chiron-tpu=chiron_tpu.cli:main",
        ]
    },
    python_requires=">=3.10",
)
