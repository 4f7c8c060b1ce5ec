"""Package metadata (parity with the reference's ``setup.py:1-25``)."""

from setuptools import find_packages, setup

setup(
    name="xgboost_ray_tpu",
    packages=find_packages(include=[
        "xgboost_ray_tpu", "xgboost_ray_tpu.*",
        "xgboost_ray_tpu_torch", "xgboost_ray_tpu_torch.*",
    ]),
    # the PyTorch/CUDA port compiles its kernels and its CSV parser from
    # these at first use
    package_data={"xgboost_ray_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                            "native/*.cpp"]},
    version="0.1.0",
    author="xgboost_ray_tpu authors",
    description="TPU-native distributed gradient-boosted-tree training with "
    "the xgboost_ray API: JAX/XLA/Pallas tpu_hist learner over a device mesh.",
    long_description="A standalone re-design of ray-project/xgboost_ray for "
    "TPU: mesh workers instead of Ray actors, psum histogram allreduce "
    "instead of Rabit, and an HBM-resident quantile-binned matrix instead "
    "of the xgboost C++ DMatrix.",
    url="https://github.com/example/xgboost_ray_tpu",
    install_requires=[
        "jax",
        "numpy",
        "pandas",
        "packaging",
    ],
    extras_require={
        "sklearn": ["scikit-learn"],
        "parquet": ["pyarrow"],
    },
    python_requires=">=3.9",
)
