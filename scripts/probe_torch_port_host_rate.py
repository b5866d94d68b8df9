"""Images per second of the port's RefineNet host stream for one or more
checkouts, each in a process of its own, in the order given.

``RefineNetDataset`` (480×640 renders, 8 corner patches an image,
``cvnp.corner_sub_pix`` once for each corner tried, up to 16) goes through
a fresh ``BatchLoader`` at 1, 2, 4 and 6 threads, as ``chip_smoke.py``
phase 15 feeds it, but on the seeded validation stream and for
``BATCHES`` batches of 8 images at every thread count, so that runs of two
checkouts render the same boards and last long enough to compare. Give
the checkouts in an alternating order (``A B B A ...``) to compare two
trees on one host. One JSON line per run.

Run from the repository root::

    python scripts/probe_torch_port_host_rate.py PARENT_ROOT . . PARENT_ROOT
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

THREADS = (1, 2, 4, 6)
BATCHES = 12

_CHILD = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
from deepcharuco_tpu_torch.configs import default_config
from deepcharuco_tpu_torch.data import BatchLoader, RefineNetDataset
cfg = default_config()
batches, rates = int(sys.argv[3]), {}
for w in json.loads(sys.argv[2]):
    loader = BatchLoader(RefineNetDataset(cfg, validation=True), 8, num_workers=w, seed=0,
                         max_batches=batches)
    t0 = time.perf_counter()
    try:
        for _ in loader:
            pass
    finally:
        loader.stop()
    rates[w] = 8 * batches / (time.perf_counter() - t0)
print(json.dumps(rates))
"""


def main(argv=None):
    roots = (argv if argv is not None else sys.argv[1:]) or ["."]
    for root in roots:
        root = os.path.abspath(root)
        done = subprocess.run([sys.executable, "-c", _CHILD, root, json.dumps(THREADS),
                               str(BATCHES)],
                              cwd=root, capture_output=True, text=True, check=True)
        rates = json.loads(done.stdout.strip().splitlines()[-1])
        print(json.dumps({"root": root, "RefineNetDataset images_per_s": rates}), flush=True)


if __name__ == "__main__":
    main()
