"""Write tests/data/torch_port_frames.npz: frames and the JAX package's
outputs on them, for checking the PyTorch/CUDA port where JAX is absent.

The frames are 8 uint8 gray 240×320 synthetic board views
(``DeviceSynthesizer(default_config()).batch(PRNGKey(2024), 8)``, mapped
back to uint8 with ``clip(rint(g·255 + 128))``). Stored outputs, all from
``deepcharuco_tpu`` on the CPU with the shipped weights on those uint8
frames:

- ``{keypoints,valid,refined}_bf16``: ``two_stage_forward`` with bf16
  models, as ``bench.py`` builds them;
- ``{keypoints,valid,refined}_f32``: the same with float32 models, as
  ``tests/test_golden.py`` builds them;
- ``{keypoints,valid}_fused``: the bf16 trunk → ``pallas_fused_head_decode``
  (interpret mode), the composition of ``cli/benchmark.py --fused-head``.

Run from the repository root: ``python scripts/make_torch_port_fixture.py``.
The file is regenerated only by this script.
"""

from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from deepcharuco_tpu.configs import default_config  # noqa: E402
from deepcharuco_tpu.data.device_synth import DeviceSynthesizer  # noqa: E402
from deepcharuco_tpu.models import Detector, RefineNet  # noqa: E402
from deepcharuco_tpu.ops import normalize_gray  # noqa: E402
from deepcharuco_tpu.ops.pallas_fused import (fold_head_params,  # noqa: E402
                                              pallas_fused_head_decode)
from deepcharuco_tpu.pipeline import two_stage_forward, variables_from_npz  # noqa: E402

OUT = os.path.join("tests", "data", "torch_port_frames.npz")
DET = "artifacts/detector_devsynth.npz"
RN = "artifacts/refinenet_devsynth.npz"


def frames(n: int = 8) -> np.ndarray:
    imgs, _, _ = DeviceSynthesizer(default_config()).batch(jax.random.PRNGKey(2024), n)
    g = np.asarray(imgs)[..., 0]
    return np.clip(np.rint(g * 255.0 + 128.0), 0, 255).astype(np.uint8)


def jax_outputs(x: np.ndarray, dtype) -> dict:
    det, rn = Detector(n_ids=16, dtype=dtype), RefineNet(dtype=dtype)
    dv, rv = variables_from_npz(DET), variables_from_npz(RN)
    kp, valid, refined = jax.jit(
        lambda dv, rv, x: two_stage_forward(det, rn, dv, rv, x, 16))(dv, rv, x)
    return {"keypoints": np.asarray(kp), "valid": np.asarray(valid),
            "refined": np.asarray(refined)}


def jax_fused(x: np.ndarray) -> dict:
    det = Detector(n_ids=16)
    dv = variables_from_npz(DET)
    folded = fold_head_params(dv, 16)
    trunk = det.apply(dv, normalize_gray(jnp.asarray(x)), trunk_only=True)["trunk"]
    kp, valid = pallas_fused_head_decode(trunk, folded, 16, interpret=True)
    return {"keypoints": np.asarray(kp), "valid": np.asarray(valid)}


def main():
    x = frames()
    out = {"frames": x}
    for tag, res in (("bf16", jax_outputs(x, jnp.bfloat16)),
                     ("f32", jax_outputs(x, jnp.float32)),
                     ("fused", jax_fused(x))):
        for k, v in res.items():
            out[f"{k}_{tag}"] = v
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(OUT, os.path.getsize(OUT), "bytes;",
          {k: int(out[f"valid_{k}"].sum()) for k in ("bf16", "f32", "fused")},
          "valid slots of", out["valid_f32"].size)


if __name__ == "__main__":
    main()
