"""The benchmark of ``deepcharuco_tpu_torch`` on one NVIDIA H100 (see
``README.md``). Imports neither JAX nor the JAX package."""
