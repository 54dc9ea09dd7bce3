from setuptools import find_packages, setup

setup(
    name="mask_rcnn_tpu",
    version="0.1.0",
    description=(
        "TPU-native Mask R-CNN framework (JAX/XLA/Pallas): ResNet-C4 "
        "instance segmentation with on-device proposals, einsum RoIAlign, "
        "and mesh data parallelism"
    ),
    packages=find_packages(
        include=["mask_rcnn_tpu", "mask_rcnn_tpu.*",
                 "mask_rcnn_tpu_torch", "mask_rcnn_tpu_torch.*"]
    ),
    package_data={
        "mask_rcnn_tpu.data": ["sbd_splits/*.txt"],
        "mask_rcnn_tpu_torch.data": ["sbd_splits/*.txt"],
        # CUDA sources, compiled with nvcc at first use on a GPU, and the
        # host evaluator's C++, compiled with g++ at first use
        "mask_rcnn_tpu_torch": ["csrc/*.cu", "native/*.cpp"],
    },
    include_package_data=True,
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "optax",
        "opencv-python",
        "pyyaml",
    ],
    extras_require={
        "data": ["scipy", "pillow"],
        "dev": ["pytest", "pandas", "tabulate"],
    },
)
