"""Multi-GPU: the ('data', 'ray') mesh over torch.distributed ranks
(counterpart of `bhnerf_tpu/parallel`)."""
from bhnerf_tpu_torch.parallel.mesh import (Mesh, create_hybrid_mesh,
                                            create_mesh,
                                            initialize_distributed,
                                            make_global_frames, replicate,
                                            shard_frames)
