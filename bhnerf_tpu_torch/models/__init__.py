from bhnerf_tpu_torch.models.fields import (MLP, NeRFParams, NeRFPredictor,
                                            params_to_numpy, posenc,
                                            sample_3d_grid)
