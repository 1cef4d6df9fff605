"""The parallelism plane — the port of ``paddle_tpu/parallel``: meshes
over ``torch.distributed`` (mesh.py), the differentiable collectives
(comm.py), dp feed sharding (data_parallel.py), mp/ep parameter
sharding (tensor_parallel.py), ring and Ulysses attention over sp
(sequence_parallel.py), GPipe and 1F1B over pp (pipeline.py), the
process-group entry point (multihost.py) and local-SGD islands
(async_sgd.py). A world starts with every rank running the same script
after :func:`init_distributed`."""

from paddle_tpu_torch.parallel import mesh as mesh_mod
from paddle_tpu_torch.parallel.mesh import (create_mesh, data_parallel_mesh,
                                            DP_AXIS, MP_AXIS, PP_AXIS,
                                            SP_AXIS)
from paddle_tpu_torch.parallel import tensor_parallel
from paddle_tpu_torch.parallel import sequence_parallel
from paddle_tpu_torch.parallel import pipeline as pipeline_mod
from paddle_tpu_torch.parallel.sequence_parallel import (attention,
                                                         ring_attention,
                                                         ulysses_attention)

__all__ = ["mesh_mod", "create_mesh", "data_parallel_mesh", "DP_AXIS",
           "MP_AXIS", "PP_AXIS", "SP_AXIS", "tensor_parallel",
           "sequence_parallel", "pipeline_mod", "attention",
           "ring_attention", "ulysses_attention"]
from paddle_tpu_torch.parallel.multihost import (  # noqa: F401,E402
    init_distributed, process_reader, global_batch, is_coordinator)
from paddle_tpu_torch.parallel.async_sgd import (  # noqa: F401,E402
    AsyncSGDIsland, average_pytree, average_local)
