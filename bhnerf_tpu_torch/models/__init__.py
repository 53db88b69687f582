from bhnerf_tpu_torch.models.fields import (GRID_Predictor, MLP, GridParams,
                                            GridPredictor, NeRF_Predictor,
                                            NeRFParams, NeRFPredictor,
                                            apply_mlp, expected_sin,
                                            init_mlp_params,
                                            integrated_posenc,
                                            params_to_numpy, posenc,
                                            sample_3d_grid)
