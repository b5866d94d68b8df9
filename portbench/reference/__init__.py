"""The plain reference: the networks, the decodes, planar PnP and the
training step in plain PyTorch, from the benchmark's own copy of the
weights' layout and the configuration. Imports nothing of the program."""
