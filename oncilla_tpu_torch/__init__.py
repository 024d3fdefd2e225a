"""oncilla_tpu_torch: the oncilla disaggregated-memory runtime on PyTorch and
CUDA, beside the JAX package ``oncilla_tpu`` (the reference it is held to).

This package imports nothing of JAX or of ``oncilla_tpu``. Its entry points
run on a CUDA device unless the caller passes ``device="cpu"``; without CUDA
and without that request they raise ``OcmDeviceError``.

Served so far: the single-node data plane (``ocm_init`` -> ``alloc`` ->
``put``/``get`` -> ``copy`` -> ``free`` on LOCAL_HOST and LOCAL_DEVICE
handles) with hand-written CUDA copy kernels for aligned transfers
(:mod:`oncilla_tpu_torch.ops.dma`); the wire client
(:mod:`oncilla_tpu_torch.runtime`: ``ocm_init`` with a nodefile attaches to
a cluster of the port's own copy of the native daemon, for REMOTE_HOST and
daemon-placed REMOTE_DEVICE handles); the one-sided device fabric
(:mod:`oncilla_tpu_torch.ops.ici`, :mod:`oncilla_tpu_torch.parallel`, the
kernel in :mod:`oncilla_tpu_torch.ops.fabric`) behind REMOTE_DEVICE
handles; bench.py's measurement path
(:mod:`oncilla_tpu_torch.benchmarks.bench`: the copy legs, the HBM ceiling
probes with their kernels in :mod:`oncilla_tpu_torch.ops.ceiling_loops`, the
size sweep, graded by :mod:`oncilla_tpu_torch.benchmarks.check`); Llama
paged-KV decode (:mod:`oncilla_tpu_torch.models`, with CUDA-graph decode
steps in :mod:`oncilla_tpu_torch.models.graphs`); the serving engine
(:mod:`oncilla_tpu_torch.serving`: tiered KV page store, prefix cache,
continuous batching); and dense Llama training on one device
(:mod:`oncilla_tpu_torch.models.train` with the AdamW of
:mod:`oncilla_tpu_torch.models.optim`, the checkpoint into oncilla memory
of :mod:`oncilla_tpu_torch.models.checkpoint`, the input prefetcher of
:mod:`oncilla_tpu_torch.utils.data`, and bench.py's MFU legs in
:mod:`oncilla_tpu_torch.benchmarks.mfu`). Public API mirrors
inc/oncillamem.h:69-89 of the reference.
"""

from oncilla_tpu_torch.core.arena import ArenaAllocator, Extent
from oncilla_tpu_torch.core.context import (
    Ocm,
    RemoteBackend,
    ocm_alloc,
    ocm_alloc_kind,
    ocm_copy,
    ocm_copy_in,
    ocm_copy_onesided,
    ocm_copy_out,
    ocm_free,
    ocm_init,
    ocm_is_remote,
    ocm_localbuf,
    ocm_remote_sz,
    ocm_tini,
)
from oncilla_tpu_torch.core.errors import (
    OcmAdmissionDenied,
    OcmBoundsError,
    OcmBreakerOpen,
    OcmBusy,
    OcmConnectError,
    OcmDeadlineExceeded,
    OcmDeviceError,
    OcmError,
    OcmInvalidHandle,
    OcmMoved,
    OcmNotPrimary,
    OcmOutOfMemory,
    OcmPlacementError,
    OcmProtocolError,
    OcmQuotaExceeded,
    OcmRemoteError,
    OcmReplicaUnavailable,
)
from oncilla_tpu_torch.core.handle import OcmAlloc
from oncilla_tpu_torch.core.kinds import Fabric, OcmKind
from oncilla_tpu_torch.utils.config import OcmConfig

__version__ = "0.1.0"

__all__ = [
    "ArenaAllocator",
    "Extent",
    "Fabric",
    "Ocm",
    "OcmAdmissionDenied",
    "OcmAlloc",
    "OcmBoundsError",
    "OcmBreakerOpen",
    "OcmBusy",
    "OcmConfig",
    "OcmConnectError",
    "OcmDeadlineExceeded",
    "OcmDeviceError",
    "OcmError",
    "OcmInvalidHandle",
    "OcmKind",
    "OcmMoved",
    "OcmNotPrimary",
    "OcmOutOfMemory",
    "OcmPlacementError",
    "OcmProtocolError",
    "OcmQuotaExceeded",
    "OcmRemoteError",
    "OcmReplicaUnavailable",
    "RemoteBackend",
    "ocm_alloc",
    "ocm_alloc_kind",
    "ocm_copy",
    "ocm_copy_in",
    "ocm_copy_onesided",
    "ocm_copy_out",
    "ocm_free",
    "ocm_init",
    "ocm_is_remote",
    "ocm_localbuf",
    "ocm_remote_sz",
    "ocm_tini",
]
