from ipp_rl_tpu_torch.parallel.mesh import (  # noqa: F401
    gather_batch,
    initialize_multihost,
    make_mesh,
    shard_batch,
)
