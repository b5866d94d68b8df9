"""Synthesis + train-step programs (``deepcharuco_tpu.parallel``).

Only the one-card part is ported: :func:`synth_scan_program`. The mesh,
sharded steps and data parallelism across cards (``parallel/mesh.py`` →
DDP) are not (ROADMAP.md §A, A7).
"""

from __future__ import annotations


def synth_scan_program(step_fn, batch_fn, fused_steps: int = 1):
    """``program(state, gen) → (state, aux)``: ``fused_steps`` rounds of
    ``step_fn(state, *batch_fn(gen))`` per call, the last round's aux
    returned (the JAX package's ``lax.scan`` over sub-keys; here a plain
    loop, each round drawing its batch from ``gen``)."""
    def program(state, gen):
        for _ in range(max(1, fused_steps)):
            state, aux = step_fn(state, *batch_fn(gen))
        return state, aux

    return program
