"""Program modules, one per model family: everything the benchmark needs to
know about the model a configuration runs. A configuration names its
module (``"program": "<name>"``, the file ``programs/<name>.py``), and
``harness.cell`` hands it to the drivers and readers as ``run.prog``, so a
new model family is a new module here, a configuration and cells, and no
edit elsewhere.

What a module offers, by the drivers that call it (a module offers what
its cells' drivers need):

- every driver: ``FAULTS`` ({name: plant(run)}, the faults the tests plant
  in the timed path; a cell lists those that must fail it), ``plant(run)``
  (the run's ``fault``, if any), ``control(c, seed, device)`` (the readings
  of the reference put in the program's place, one precision below the
  configuration's, on the inputs a run of ``seed`` judges, which the
  cell's driver makes with ``control_inputs``), and
  ``flops_per_item(cfg, task)`` (analytic FLOPs of one frame served, task
  ``"serve"``, or one sample trained, ``"train"``);
- serving drivers (``offline``, ``stream``): ``build(cfg, root, seed,
  device)`` (the system: ``forward_device(frames, with_pose)`` returns a
  tuple of device tensors, one per name in ``OUTPUTS``), ``instrument(spans,
  system, layers)`` (the traced run's spans) and ``judge(cfg, root, seed,
  device, frames, out)`` (the readings of the answers ``out``, keyed by
  ``OUTPUTS``, against the plain reference);
- training drivers (``train_step``, ``train_devsynth``):
  ``initial_state(cfg, seed, device)`` (the start, made on the device from
  the seed), ``train_state(cfg, start, device)`` (the port's training state
  and step function), ``synthesizer(cfg, device)`` (the port's on-card
  batch synthesizer), ``train_reference(cfg, start, batches, q)`` and
  ``judge_train(record, reference)``.
"""
