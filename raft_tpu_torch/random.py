"""pylibraft-shaped namespace ``raft_tpu_torch.random`` (counterpart of
``raft_tpu.random``; ``pylibraft.random``: rmat), with the generators of
``ops.rng``."""

from raft_tpu_torch.ops.rng import (  # noqa: F401
    RngState,
    bernoulli,
    exponential,
    gumbel,
    laplace,
    lognormal,
    make_blobs,
    make_regression,
    multi_variable_gaussian,
    normal,
    permute,
    rayleigh,
    rmat,
    sample_without_replacement,
    subsample_rows,
    uniform,
)

__all__ = ["RngState", "rmat", "make_blobs", "make_regression",
           "multi_variable_gaussian", "normal", "uniform", "laplace",
           "gumbel", "lognormal", "exponential", "rayleigh", "bernoulli",
           "permute", "sample_without_replacement", "subsample_rows"]
