from deepcharuco_tpu_torch.models.detector import Detector
from deepcharuco_tpu_torch.models.lightglue import LightGlue
from deepcharuco_tpu_torch.models.refinenet import RefineNet
from deepcharuco_tpu_torch.models.superpoint import SuperPoint

__all__ = ["Detector", "LightGlue", "RefineNet", "SuperPoint"]
