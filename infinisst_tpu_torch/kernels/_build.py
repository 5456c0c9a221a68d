"""Build the port's CUDA sources (``infinisst_tpu_torch/csrc/*.cu``) at
first use and load them with ctypes.

``torch.utils.cpp_extension.load`` compiles each source for ``sm_90a``
into ``build/torch_kernels/`` at the repository root.  The sources have a
plain C interface and include no PyTorch header, so a build takes seconds.
A failed build raises; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import os

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]
# every kernel source of the package
SOURCES = ("quant_matmul", "grouped_matmul", "decode_attention", "norm_quant")

_libs = {}


def load_library(name: str) -> ctypes.CDLL:
    """Build (once per process) and load ``csrc/<name>.cu``."""
    if name in _libs:
        return _libs[name]
    from torch.utils.cpp_extension import load

    build_dir = os.path.join(BUILD_DIR, name)
    os.makedirs(build_dir, exist_ok=True)
    load(
        name=f"infinisst_{name}",
        sources=[os.path.join(CSRC_DIR, f"{name}.cu")],
        build_directory=build_dir,
        extra_cuda_cflags=CUDA_FLAGS,
        extra_include_paths=[CSRC_DIR],
        is_python_module=False,
    )
    lib = ctypes.CDLL(os.path.join(build_dir, f"infinisst_{name}.so"))
    _libs[name] = lib
    return lib


def load_all(names=SOURCES):
    """Build every source at once, one nvcc per source, in parallel."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for f in [pool.submit(load_library, n) for n in names]:
            f.result()
