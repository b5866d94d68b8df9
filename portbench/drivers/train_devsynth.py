"""The detector's training on batches the card synthesises, as ``cli.train
--device-synth`` runs it at one step a dispatch: the program module's
``synthesizer`` draws every step's batch from one ``torch.Generator`` on
the device, seeded from ``--seed``, through
``parallel.synth_scan_program(step, lambda g: synth.batch(g, batch),
fused_steps=1)``; the state, its step and its first ``checked_steps`` steps
in set-up are ``train_step``'s.

The reference cannot draw those batches again, so while set-up drives the
checked steps through the window's own dispatch, the batch function keeps
a host copy of each batch it hands to the step; the reference's Adam runs
on those copies. ``repeated_batches`` counts checked batches equal to an
earlier one, and the program module's ``synth_readings`` hold the
synthesizer's labels to what they must be whatever it draws.

``train_samples_per_s``: as ``train_step``'s, synthesis included.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from portbench.drivers import train_step

TASK = "train"
SMALL = dict(batch=2, warm_steps=1, trace_skip=1, trace_steps=1, trace_drop=0)


def feed_seed(seed: int) -> int:
    """The feed generator's seed: drawn from ``--seed`` apart from the
    initial parameters' draw, which seeds its own generator with it."""
    return int(np.random.SeedSequence([seed, 1]).generate_state(1, np.uint64)[0] >> 1)


def repeated(batches) -> int:
    """Batches equal, in every tensor, to an earlier one."""
    return sum(any(all(torch.equal(a, b) for a, b in zip(batches[i], batches[j]))
                   for j in range(i)) for i in range(len(batches)))


def batch_readings(cfg: dict, prog, batches) -> dict:
    return {"repeated_batches": repeated(batches), **prog.synth_readings(cfg, batches)}


def control_inputs(c: dict, seed: int, device) -> dict:
    """The batches of the checked steps of a run of ``seed``, drawn as its
    set-up draws them, and their readings."""
    cfg, p = c["config"], c["params"]
    synth = c["program"].synthesizer(cfg, device)
    gen = torch.Generator(device=device).manual_seed(feed_seed(seed))
    batches = [synth.batch(gen, p["batch"]) for _ in range(p["checked_steps"])]
    return {"batches": batches,
            "readings": batch_readings(cfg, c["program"], [tuple(t.cpu() for t in b)
                                                           for b in batches])}


class Run(train_step.Run):
    def prepare(self):
        self.synth = self.prog.synthesizer(self.cfg, self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(feed_seed(self.seed))
        self.kept = []
        self.span_synth = False

    def bind(self):
        from deepcharuco_tpu_torch.parallel import synth_scan_program

        self.dispatch = synth_scan_program(self.step, self.batch, fused_steps=1)

    def batch(self, gen):
        with self.spans.span("portbench.synth") if self.span_synth else nullcontext():
            b = self.synth.batch(gen, self.p["batch"])
        if len(self.kept) < self.p["checked_steps"]:
            self.kept.append(tuple(t.cpu() for t in b))
        return b

    def advance(self, i: int) -> dict:
        self.state, aux = self.dispatch(self.state, self.gen)
        return aux

    def checked_batches(self) -> list:
        return [tuple(t.to(self.device) for t in b) for b in self.kept]

    def window(self):
        self.span_synth = self.trace
        super().window()

    def judge(self):
        return {**super().judge(), **batch_readings(self.cfg, self.prog, self.kept)}
