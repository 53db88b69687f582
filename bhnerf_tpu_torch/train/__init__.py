from bhnerf_tpu_torch.train.optimizer import (LogFn, Optimizer,
                                              TemporalBatchedArgs, TrainStep,
                                              total_movie_loss)
from bhnerf_tpu_torch.train.state import (TrainState, latest_checkpoint_step,
                                          make_optimizer, restore_checkpoint,
                                          restore_params, save_checkpoint)
from bhnerf_tpu_torch.train.step import (CompactRayArgs, RayTracingArgs,
                                         apply_measurement_operator,
                                         compact_ensemble_args,
                                         compact_raytracing_args,
                                         image_plane_prediction,
                                         loss_fn_eht, loss_fn_image,
                                         make_composed_scan_step,
                                         make_scan_step, make_step_fns,
                                         raytracing_args, stack_ensemble,
                                         to_real_measurements)
