"""Training data made on the card (``deepcharuco_tpu.data``'s on-device
synthesis; the host pipeline is not ported, ROADMAP.md §A)."""

from deepcharuco_tpu_torch.data.device_synth import (
    DeviceRefineSynthesizer,
    DeviceSynthesizer,
    FramePatchSynthesizer,
)

__all__ = ["DeviceSynthesizer", "FramePatchSynthesizer", "DeviceRefineSynthesizer"]
