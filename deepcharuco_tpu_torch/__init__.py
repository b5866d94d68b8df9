"""deepcharuco_tpu_torch — the PyTorch/CUDA port of deepcharuco_tpu.

Runs the Deep ChArUco inference pipeline (frames → corners → sub-pixel
corners → board pose) and on-card training on an NVIDIA H100, with the JAX
package's two Pallas kernels
written by hand in CUDA C++ for ``sm_90a``. The JAX package is the
reference; the port imports nothing of it.

Layout
------
- :mod:`deepcharuco_tpu_torch.configs`  — config schema (own copy)
- :mod:`deepcharuco_tpu_torch.board`    — board geometry, a numpy ChArUco renderer,
  the cv2 helpers (cv2 imported inside each; own copy)
- :mod:`deepcharuco_tpu_torch.weights`  — shipped ``.npz`` weights ⇄ state dicts
- :mod:`deepcharuco_tpu_torch.compat`   — Lightning ``.ckpt`` ⇄ the weight tree
- :mod:`deepcharuco_tpu_torch.models`   — Detector, RefineNet (``nn.Module``)
- :mod:`deepcharuco_tpu_torch.ops`      — image, decode and patch ops; the
  CUDA kernels' wrappers (``cuda_decode``, ``cuda_fused``)
- :mod:`deepcharuco_tpu_torch.pnp`      — batched planar PnP (camera model,
  small linear algebra, DLT + Levenberg–Marquardt, RANSAC)
- :mod:`deepcharuco_tpu_torch.pipeline` — ``two_stage_forward[_hires]``,
  ``full_forward[_hires]``, ``Camera``, ``InferencePipeline``, ``load_pipeline``,
  ``load_model_variables``
- :mod:`deepcharuco_tpu_torch.data`     — on-card synthesis (``device_synth``)
- :mod:`deepcharuco_tpu_torch.train`    — steps, losses, metrics, checkpoints,
  logging; :mod:`deepcharuco_tpu_torch.parallel` — ``synth_scan_program``
- :mod:`deepcharuco_tpu_torch.cli`      — ``train``, ``train_refinenet``,
  ``benchmark``, ``infer``, ``eval``, ``pose_video``
- :mod:`deepcharuco_tpu_torch.bench`    — the benchmark harness
  (``python -m deepcharuco_tpu_torch.bench``)
- :mod:`deepcharuco_tpu_torch.pose_filter`, :mod:`deepcharuco_tpu_torch.utils` —
  temporal pose filter, pixel errors, ``save_video`` (own copies)
- ``assets/board_renders.npz`` — the default board's renders and the ArUco
  dictionaries' bits
- ``csrc/`` — CUDA sources, built on first use by ``_build``

Every entry point runs on the card unless the caller passes
``device="cpu"``; without a card and without that, it raises.
"""

__version__ = "0.1.0"
