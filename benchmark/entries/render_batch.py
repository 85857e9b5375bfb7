"""`BinauralRenderer.render_batch`: S sources, each along its own
per-block path, rendered independently with no mixdown (closed loop,
`harness/offline.py`).

The reference renders each source of a kept input alone through
`fast.render` (one source is `golden.render_trajectory`) and stacks the
results to (S, 2, out_len): the map `render_batch` promises."""

import torch

from benchmark.harness import system
from benchmark.harness.offline import Offline
from benchmark.reference import fast


class Entry(Offline):
    method = "render_batch"

    def reference_outputs(self, prec=fast.FLOAT64):
        cfg = self.cell.config
        tab = fast.device_table(system.reference_table(cfg, self.h),
                                self.device, prec)
        rcfg = system.reference_config(cfg)
        for k in sorted(self.kept):
            xs, dirs = self.inputs[k]
            yield k, torch.stack([fast.render(tab, xs[s:s + 1],
                                              dirs[s:s + 1], rcfg)
                                  for s in range(xs.shape[0])])
