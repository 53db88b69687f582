from bhnerf_tpu_torch.train.optimizer import (LogFn, Optimizer,
                                              TemporalBatchedArgs, TrainStep)
from bhnerf_tpu_torch.train.state import TrainState, make_optimizer
from bhnerf_tpu_torch.train.step import (CompactRayArgs, RayTracingArgs,
                                         compact_raytracing_args,
                                         image_plane_prediction,
                                         loss_fn_image, make_step_fns,
                                         raytracing_args)
