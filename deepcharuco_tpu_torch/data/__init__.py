"""Training data (``deepcharuco_tpu.data``): the host pipeline (numpy and
:mod:`~deepcharuco_tpu_torch.data.cvnp` in threads, no cv2 needed) and the
synthesis on the card."""

from deepcharuco_tpu_torch.data.dataset import (
    CharucoDataset,
    RefineNetDataset,
    create_label,
    create_refine_sample,
    normalize_image_host,
)
from deepcharuco_tpu_torch.data.device_synth import (
    DeviceRefineSynthesizer,
    DeviceSynthesizer,
    FramePatchSynthesizer,
    make_background_bank,
)
from deepcharuco_tpu_torch.data.prefetch import BatchLoader, device_prefetch
from deepcharuco_tpu_torch.data.sources import (
    CocoJsonImageSource,
    DirectoryImageSource,
    ProceduralImageSource,
    open_image_source,
)
from deepcharuco_tpu_torch.data.synth import BoardSynthesizer, SynthSample

__all__ = [
    "BoardSynthesizer",
    "SynthSample",
    "CharucoDataset",
    "RefineNetDataset",
    "create_label",
    "create_refine_sample",
    "normalize_image_host",
    "DirectoryImageSource",
    "CocoJsonImageSource",
    "ProceduralImageSource",
    "open_image_source",
    "BatchLoader",
    "device_prefetch",
    "DeviceSynthesizer",
    "FramePatchSynthesizer",
    "DeviceRefineSynthesizer",
    "make_background_bank",
]
