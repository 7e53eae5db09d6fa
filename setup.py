from setuptools import find_packages, setup

setup(
    name="monai_tpu",
    version="0.1.0",
    description="TPU-native medical imaging AI framework (JAX/XLA/Pallas), with its "
                "PyTorch/CUDA port monai_tpu_torch",
    # finds both monai_tpu and monai_tpu_torch
    packages=find_packages(exclude=("tests",)),
    package_data={"monai_tpu_torch": ["csrc/*.cu*"]},  # the sources and their header, built by nvcc at first use
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "orbax-checkpoint", "numpy", "scipy"],
    extras_require={
        "full": ["pandas", "pillow", "pyyaml", "einops", "chex"],
        # monai_tpu_torch: PyTorch; its kernels need a CUDA build of torch and nvcc on
        # the GPU machine (all of them are CUDA C++; none needs triton)
        "torch": ["torch>=2.2", "numpy"],
    },
)
