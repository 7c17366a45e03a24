from setuptools import find_packages, setup

setup(
    name="syzgydb-tpu",
    version="0.1.0",
    description="TPU-native embeddable vector database "
                "(SyzgyDB-compatible API)",
    packages=find_packages(exclude=("tests",)),
    package_data={"syzgydb_tpu.native": ["libspanlog_core.so"],
                  # the port builds its CUDA kernels from these at first use
                  "syzgydb_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
                  # the embedder's shipped checkpoint (DEFAULT_CHECKPOINT)
                  "syzgydb_tpu_torch.models": ["checkpoints/*.ckpt"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "flax"],
    entry_points={
        "console_scripts": ["syzgy-tpu=syzgydb_tpu.tools.cli:main",
                            "syzgy-torch=syzgydb_tpu_torch.tools.cli:main"],
    },
)
