"""Shape and tile helpers, the persistent build directory
(``enable_persistent_cache``) and the opt-in runtime checks
(``raft_tpu_torch.utils.debug``)."""

from raft_tpu_torch.utils.compile_cache import enable_persistent_cache
from raft_tpu_torch.utils.shape import cdiv, pad_rows, round_up_to

__all__ = ["round_up_to", "pad_rows", "cdiv", "enable_persistent_cache"]
