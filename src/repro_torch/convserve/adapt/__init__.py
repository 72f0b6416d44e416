"""Online adaptive replanning: measured costs replace the roofline.

The S5 analytical model plans well in the common case but mispredicts in
exactly the regime the paper targets (`fft-fewchannel`: the model picks
fused FFT; on the paper's CPU path measurement says direct is ~2x
faster, and on the card the loop measures the tile kernel against
cuDNN).  This package closes the loop against a LIVE serving runtime:

  measure -> diverge -> replan -> shadow -> promote / rollback

* `costs`     -- measured-cost wisdom store (EWMA, cold-compile
                 excluded), keyed like `tune.py` wisdom.
* `replanner` -- divergence monitor + background replanner: when
                 measured stage times drift past a threshold relative
                 to the roofline predictions, `plan_net` re-runs with
                 measured costs overriding the `HardwareModel`.
* `shadow`    -- A/B verifier: a trickle of live waves is duplicated
                 onto the candidate program, exactness asserted,
                 latency compared.
* `swap`      -- zero-downtime hot swap: warm the candidate at every
                 compiled shape, drain in-flight waves, atomically
                 switch dispatch, invalidate the old program's cache
                 entries.
"""

from repro_torch.convserve.adapt.costs import CostEntry, MeasuredCostStore
from repro_torch.convserve.adapt.replanner import AdaptConfig, AdaptController
from repro_torch.convserve.adapt.shadow import ShadowVerifier
from repro_torch.convserve.adapt.swap import hot_swap

__all__ = [
    "AdaptConfig",
    "AdaptController",
    "CostEntry",
    "MeasuredCostStore",
    "ShadowVerifier",
    "hot_swap",
]
