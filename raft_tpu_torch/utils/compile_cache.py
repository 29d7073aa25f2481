"""The persistent build directory of the port's compiled code (counterpart
of ``raft_tpu.utils.compile_cache``, which turns on XLA's on-disk
compilation cache; RAFT ships ``libraft`` precompiled for the same
reason).

The port compiles two things at first use and keys each build by a hash of
its source and flags: the CUDA kernels (``ops.gpu_kernels.BUILD_DIR``,
``nvcc``) and the host C++ library (``native.BUILD_DIR``, ``g++``, in
``native/`` under the directory). Pointing both at a directory that
outlives the process is the persistent cache.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

#: where the builds go unless told otherwise: the repository's
#: ``build/raft_tpu_torch``
DEFAULT_DIR = Path(__file__).resolve().parents[2] / "build" / "raft_tpu_torch"


def enable_persistent_cache(cache_dir: Optional[str] = None,
                            min_compile_time_secs: float = 1.0) -> str:
    """Build the kernels into ``cache_dir`` and the native library into its
    ``native/`` (default: ``RAFT_TPU_CACHE_DIR`` if set, else
    ``build/raft_tpu_torch``); returns the directory. Idempotent. Libraries
    already loaded in this process stay loaded; later builds and loads use
    the directory. ``min_compile_time_secs`` is accepted for the JAX
    package's signature and has no effect: every build is kept, keyed by
    its source's hash."""
    from raft_tpu_torch import native
    from raft_tpu_torch.ops import gpu_kernels

    path = Path(cache_dir or os.environ.get("RAFT_TPU_CACHE_DIR")
                or DEFAULT_DIR).resolve()
    path.mkdir(parents=True, exist_ok=True)
    gpu_kernels.BUILD_DIR = path
    native.BUILD_DIR = path / "native"
    return str(path)
