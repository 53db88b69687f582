from bhnerf_tpu_torch.models.fields import (MLP, NeRFParams, NeRFPredictor,
                                            posenc)
