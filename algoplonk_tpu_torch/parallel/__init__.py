"""Sharded and batch proving (counterpart of ``algoplonk_tpu/parallel/``).

``Mesh`` (``mesh.py``) is a one-axis list of torch devices driven from one
process, devices may repeat; ``sharded_msm_fn`` and ``sharded_ntt_fn`` run
the MSM and the four-step NTT over it, and ``Prover(mesh=...)`` runs every
commit and every NTT it can shard through them (``ntt_sharded.Sharding``).
``prove_batch`` proves many witnesses of one circuit at once, one worker
thread and one CUDA stream per entry of its device list."""

from .batch_prove import prove_batch
from .mesh import Mesh, all_gather, all_to_all
from .msm_sharded import sharded_msm_fn
from .ntt_sharded import sharded_ntt_fn

__all__ = ["Mesh", "all_gather", "all_to_all", "prove_batch", "sharded_msm_fn",
           "sharded_ntt_fn"]
