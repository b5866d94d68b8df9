"""The pair matcher's spans and counters (``matching.MatchPipeline``,
``models.lightglue``) in the port's recorder, on the CPU at a small size
with the published depth of 9 layers: one ``forward_device`` call records
``match.superpoint``, ``match.keypoints``, ``match.lightglue`` and
``match.assign`` once each, two ``match.attention`` a layer (the self
block's and the cross block's, whose two directions are one call) inside
``match.lightglue``, and adds the pairs and the layers to ``match.pairs``
and ``match.layers``; served through ``pipelined_map`` the stages sit under
the batch's ``serving.launch``."""

import time

import numpy as np
import torch

from deepcharuco_tpu_torch import profiling
from deepcharuco_tpu_torch.matching import MatchPipeline
from deepcharuco_tpu_torch.serving import pipelined_map
from reference import superpoint_lightglue as R

LAYERS = 9
STAGES = ("match.superpoint", "match.keypoints", "match.lightglue", "match.assign")
CONF = dict(descriptor_dim=32, n_layers=LAYERS, num_heads=2,
            weight_draw=dict(scores_gain=4.0, attn_gain=12.0, ffn_out_gain=0.03,
                             final_proj_gain=20.0, matchability_bias=4.0))


def pipe():
    sp, lg = R.draw_weights(CONF, 7)
    return MatchPipeline(sp, lg, max_num_keypoints=16, descriptor_dim=32, n_layers=LAYERS,
                         num_heads=2, compute_dtype=torch.float32, device="cpu")


def frames(pairs=2):
    return np.random.default_rng(0).integers(0, 256, (2 * pairs, 32, 48), dtype=np.uint8)


def recorded(t0):
    return [s for s in profiling.spans() if s.t0 >= t0 and s.name.startswith("match.")]


def test_one_call_records_each_stage_once_and_two_attention_calls_a_layer():
    p = pipe()
    before = profiling.counters()
    t0 = time.perf_counter_ns()
    p.forward_device(torch.from_numpy(frames(3)))
    got = recorded(t0)
    names = [s.name for s in got]
    for stage in STAGES:
        assert names.count(stage) == 1, stage
    attention = [s for s in got if s.name == "match.attention"]
    assert len(attention) == 2 * LAYERS
    lightglue = next(s for s in got if s.name == "match.lightglue")
    assert all(s.parent is lightglue for s in attention)
    assert all(s.ev0 is None for s in got)          # no device events on the CPU
    after = profiling.counters()
    assert after["match.pairs"] - before.get("match.pairs", 0) == 3
    assert after["match.layers"] - before.get("match.layers", 0) == LAYERS


def test_served_batches_hold_their_stages():
    p = pipe()
    t0 = time.perf_counter_ns()
    outs = list(pipelined_map(p.forward_device, [frames(), frames()], 2, "cpu"))
    assert len(outs) == 2 and len(outs[0]) == 4
    launches = [s for s in profiling.spans("serving.launch") if s.t0 >= t0]
    stages = [s for s in recorded(t0) if s.name in STAGES]
    assert len(launches) == 2 and len(stages) == 2 * len(STAGES)
    assert all(s.parent in launches for s in stages)
