from deepcharuco_tpu_torch.models.detector import Detector
from deepcharuco_tpu_torch.models.refinenet import RefineNet

__all__ = ["Detector", "RefineNet"]
